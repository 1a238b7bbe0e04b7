// K0: the Triplane+CP encoding alone, K3: plane / CP-line gradients, and
// K4: coordinate gradients.
//
// K0 replaces mipsfusion_tpu/ops/triplane_pallas.py _fused_forward
// (_make_fwd_kernel), the forward of triplane_encode_pallas. The TPU built
// each lookup as a one-hot matmul over a 2048-point block with bf16 planes.
// Here one thread per point gathers, per scale, the 4 taps of each of the
// three planes (float4 reads of F = 4) and, for the CP term, 2 taps of
// each of the three lines per group of 4 channels, with the device
// functions K1 uses (common.cuh scale_lookup, cp_lookup4), so K0 and K1
// share one interpolation, the upper-tap clamp included. It writes the
// [N, 48] row layout of triplane_encode_pallas (12 float4 stores a point).
// The tables (48 + 192 + 180 KB) stay in L2; it is bound by the latency of
// ~84 dependent gathers a point, not by device-memory bandwidth.
// Precision: float32 storage and math (the TPU cast planes and CP to bf16).
//
// K3 replaces mipsfusion_tpu/ops/triplane_pallas.py _fused_backward_plane
// (_make_bwd_plane_kernel). The TPU computed the scatter as a transposed
// one-hot matmul accumulated across its sequential grid. Here one thread
// per point scatters its bilinear (4-tap) and linear (2-tap) weights times
// d_embed with float32 atomicAdd into the zeroed gradients: 96 plane and
// up to 240 CP atomics per point. Neighbouring ray samples hit the same
// cells, so it is bound by atomic contention in L2, not by bandwidth.
// Atomics make the summation order run-dependent: results agree with a
// fixed-order sum to float32 rounding of the gradient magnitude (the
// tolerance chip_smoke.py states). Precision: float32.
//
// K4 replaces triplane_pallas.py _fused_backward_x (_make_bwd_x_kernel).
// One thread per point, no reduction: d_x from the derivative taps of the
// plane and CP interpolation times (R-1). As the TPU kernel, the
// derivative is the tent derivative at the clamped coordinate, also for
// points outside [0, 1] (where the composite autodiff path gives 0), and
// at the upper clamp, where row i0+1 does not exist, it is -P[R-1].
// Bound by the gather latency of 24 plane and 6 CP-row reads per point.
// Precision: float32.

#include "common.cuh"

namespace mf {

constexpr int K34_THREADS = 128;
constexpr int K0_THREADS = 128;

__global__ void __launch_bounds__(K0_THREADS)
    encode_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ s0,
                      const float* __restrict__ s1,
                      const float* __restrict__ cp, int N,
                      float* __restrict__ out) {
  const int n = blockIdx.x * K0_THREADS + threadIdx.x;
  if (n >= N) return;
  const float xp[3] = {x[3 * (size_t)n], x[3 * (size_t)n + 1],
                       x[3 * (size_t)n + 2]};
  float4* o = reinterpret_cast<float4*>(out + (size_t)n * EMB);
  o[0] = scale_lookup<R0>(s0, xp);
  o[1] = scale_lookup<R1>(s1, xp);
#pragma unroll 2
  for (int c = 0; c < CCP; c += 4) o[2 + c / 4] = cp_lookup4(cp, xp, c);
}

template <int R>
__device__ __forceinline__ void scatter_plane(float* dP, const Tap& u,
                                              const Tap& v, float4 g) {
  float wu[2] = {1.0f - u.w, u.w}, wv[2] = {1.0f - v.w, v.w};
  int iu[2] = {u.i0, u.i1}, iv[2] = {v.i0, v.i1};
  bool ok_u[2] = {true, u.has_next}, ok_v[2] = {true, v.has_next};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!ok_u[a]) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (!ok_v[b]) continue;
      float w = wu[a] * wv[b];
      float* dst = dP + (iu[a] * R + iv[b]) * FEAT;
      atomicAdd(dst + 0, w * g.x);
      atomicAdd(dst + 1, w * g.y);
      atomicAdd(dst + 2, w * g.z);
      atomicAdd(dst + 3, w * g.w);
    }
  }
}

template <int R>
__device__ __forceinline__ void scatter_scale(float* dS, const float x[3],
                                              float4 g) {
  Tap t[3] = {make_tap<R>(x[0]), make_tap<R>(x[1]), make_tap<R>(x[2])};
  const int RR = R * R * FEAT;
  scatter_plane<R>(dS, t[0], t[1], g);
  scatter_plane<R>(dS + RR, t[0], t[2], g);
  scatter_plane<R>(dS + 2 * RR, t[1], t[2], g);
}

__global__ void __launch_bounds__(K34_THREADS)
    plane_bwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ d_embed,
                     const float* __restrict__ cp, int N,
                     float* __restrict__ d_s0, float* __restrict__ d_s1,
                     float* __restrict__ d_cp) {
  const int n = blockIdx.x * K34_THREADS + threadIdx.x;
  if (n >= N) return;
  const size_t S = N;
  float xp[3] = {x[n], x[S + n], x[2 * S + n]};
  float4 g0 = make_float4(d_embed[n], d_embed[S + n], d_embed[2 * S + n],
                          d_embed[3 * S + n]);
  float4 g1 = make_float4(d_embed[4 * S + n], d_embed[5 * S + n],
                          d_embed[6 * S + n], d_embed[7 * S + n]);
  scatter_scale<R0>(d_s0, xp, g0);
  scatter_scale<R1>(d_s1, xp, g1);

  Tap t[3] = {make_tap<RCP>(xp[0]), make_tap<RCP>(xp[1]), make_tap<RCP>(xp[2])};
#pragma unroll 2
  for (int c = 0; c < CCP; ++c) {
    float f[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* L = cp + (size_t)a * RCP * CCP;
      f[a] = (1.0f - t[a].w) * __ldg(L + t[a].i0 * CCP + c) +
             t[a].w * __ldg(L + t[a].i1 * CCP + c);
    }
    float gc = d_embed[(size_t)(2 * FEAT + c) * S + n];
    float others[3] = {f[1] * f[2], f[0] * f[2], f[0] * f[1]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float da = gc * others[a];
      float* L = d_cp + (size_t)a * RCP * CCP;
      atomicAdd(L + t[a].i0 * CCP + c, (1.0f - t[a].w) * da);
      if (t[a].has_next) atomicAdd(L + t[a].i1 * CCP + c, t[a].w * da);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// (du, dv) of one plane at taps (u, v) for feature cotangent g.
template <int R>
__device__ __forceinline__ void plane_dx(const float* P, const Tap& u,
                                         const Tap& v, float4 g, float& du,
                                         float& dv) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 p00 = ld4(P + (u.i0 * R + v.i0) * FEAT);
  float4 p01 = ld4(P + (u.i0 * R + v.i1) * FEAT);
  float4 p10 = ld4(P + (u.i1 * R + v.i0) * FEAT);
  float4 p11 = ld4(P + (u.i1 * R + v.i1) * FEAT);
  // rows/cols i0+1 read as 0 where they do not exist
  float4 pn0 = u.has_next ? p10 : z, pn1 = u.has_next ? p11 : z;
  float4 p0n = v.has_next ? p01 : z, p1n = v.has_next ? p11 : z;
  float4 gu = sub4(pn0, p00), gu1 = sub4(pn1, p01);
  float4 gv = sub4(p0n, p00), gv1 = sub4(p1n, p10);
  du = ((1.0f - v.w) * dot4(g, gu) + v.w * dot4(g, gu1)) * (float)(R - 1);
  dv = ((1.0f - u.w) * dot4(g, gv) + u.w * dot4(g, gv1)) * (float)(R - 1);
}

template <int R>
__device__ __forceinline__ void scale_dx(const float* Sp, const float x[3],
                                         float4 g, float dx[3]) {
  Tap t[3] = {make_tap<R>(x[0]), make_tap<R>(x[1]), make_tap<R>(x[2])};
  const int RR = R * R * FEAT;
  float du, dv;
  plane_dx<R>(Sp, t[0], t[1], g, du, dv);            // xy
  dx[0] += du; dx[1] += dv;
  plane_dx<R>(Sp + RR, t[0], t[2], g, du, dv);       // xz
  dx[0] += du; dx[2] += dv;
  plane_dx<R>(Sp + 2 * RR, t[1], t[2], g, du, dv);   // yz
  dx[1] += du; dx[2] += dv;
}

__global__ void __launch_bounds__(K34_THREADS)
    x_bwd_kernel(const float* __restrict__ x,
                 const float* __restrict__ d_embed,
                 const float* __restrict__ s0, const float* __restrict__ s1,
                 const float* __restrict__ cp, int N,
                 float* __restrict__ d_x) {
  const int n = blockIdx.x * K34_THREADS + threadIdx.x;
  if (n >= N) return;
  const size_t S = N;
  float xp[3] = {x[n], x[S + n], x[2 * S + n]};
  float4 g0 = make_float4(d_embed[n], d_embed[S + n], d_embed[2 * S + n],
                          d_embed[3 * S + n]);
  float4 g1 = make_float4(d_embed[4 * S + n], d_embed[5 * S + n],
                          d_embed[6 * S + n], d_embed[7 * S + n]);
  float dx[3] = {0.f, 0.f, 0.f};
  scale_dx<R0>(s0, xp, g0, dx);
  scale_dx<R1>(s1, xp, g1, dx);

  Tap t[3] = {make_tap<RCP>(xp[0]), make_tap<RCP>(xp[1]), make_tap<RCP>(xp[2])};
  float dcp[3] = {0.f, 0.f, 0.f};
#pragma unroll 2
  for (int c = 0; c < CCP; ++c) {
    float f[3], df[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* L = cp + (size_t)a * RCP * CCP;
      float lo = __ldg(L + t[a].i0 * CCP + c);
      float hi = __ldg(L + t[a].i1 * CCP + c);
      f[a] = (1.0f - t[a].w) * lo + t[a].w * hi;
      df[a] = (t[a].has_next ? hi : 0.0f) - lo;
    }
    float gc = d_embed[(size_t)(2 * FEAT + c) * S + n];
    dcp[0] += gc * df[0] * f[1] * f[2];
    dcp[1] += gc * df[1] * f[0] * f[2];
    dcp[2] += gc * df[2] * f[0] * f[1];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
    d_x[a * S + n] = dx[a] + dcp[a] * (float)(RCP - 1);
}

}  // namespace mf

using namespace mf;

extern "C" int mf_encode_forward(const float* x, const float* s0,
                                 const float* s1, const float* cp, int n,
                                 float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int grid = (n + K0_THREADS - 1) / K0_THREADS;
  encode_fwd_kernel<<<grid, K0_THREADS, 0, (cudaStream_t)stream>>>(
      x, s0, s1, cp, n, out);
  return (int)cudaGetLastError();
}

extern "C" int mf_plane_backward(const float* x, const float* d_embed,
                                 const float* cp, int n, float* d_s0,
                                 float* d_s1, float* d_cp, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int grid = (n + K34_THREADS - 1) / K34_THREADS;
  plane_bwd_kernel<<<grid, K34_THREADS, 0, (cudaStream_t)stream>>>(
      x, d_embed, cp, n, d_s0, d_s1, d_cp);
  return (int)cudaGetLastError();
}

extern "C" int mf_x_backward(const float* x, const float* d_embed,
                             const float* s0, const float* s1,
                             const float* cp, int n, float* d_x,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int grid = (n + K34_THREADS - 1) / K34_THREADS;
  x_bwd_kernel<<<grid, K34_THREADS, 0, (cudaStream_t)stream>>>(
      x, d_embed, s0, s1, cp, n, d_x);
  return (int)cudaGetLastError();
}
