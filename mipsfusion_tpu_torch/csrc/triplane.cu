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
// one-hot matmul accumulated across its sequential grid, which gives the
// same sums in every run. Here it is a scatter of bilinear (4-tap) and
// linear (2-tap) weights times d_embed; its bound is the ~40 MB of I/O,
// its limit the atomics. The loop's points are ray samples, each ray's
// samples contiguous, so a warp's 32 lanes mostly hit few cells: a warp
// first sums, per tap, the float4 of the lanes that share a cell (a
// segmented shuffle scan over runs of equal cells), and the run's last
// lane adds the sum; the CP lines are channel-parallel (lanes over a
// line's 40 channels, one add per run of a cell).
// Determinism: float atomics would make the summation order, and so the
// rounding, differ from run to run, and the SLAM loop's decisions amplify
// that. So each add goes to an int64 accumulator in fixed point with a
// power-of-two scale (one 64-bit integer atomic per channel); integer
// addition is associative, so every run gives the same bits. A first
// kernel takes max |d_embed| and max |cp| (an order-free max); the scale
// is the largest power of two at which N contributions of that size
// cannot overflow 2^62, which keeps the rounding error of a sum below
// N^2 / 2^62 of the largest contribution (8e-9 of it at N = 195,000),
// below float32 atomics' own. A last kernel converts to float32.
// Precision: float32 products and run sums, fixed-point totals.
//
// K4 replaces mipsfusion_tpu/ops/triplane_pallas.py _fused_backward_x
// (_make_bwd_x_kernel): d_x from the derivative taps of the plane and CP
// interpolation times (R-1). As the TPU kernel, the derivative is the tent
// derivative at the clamped coordinate, also for points outside [0, 1]
// (where the composite autodiff path gives 0), and at the upper clamp,
// where row i0+1 does not exist, it is -P[R-1]. Its bound is bytes (216 B
// a point in and out); what it costs is 84 16-byte gathers a point from
// the tables in L1/L2, so the design keeps many of them in flight and few
// cache lines per load: the four lanes of a quad share a point. Lane t < 3
// takes plane t (xy, xz, yz) of both scales (8 gathers), and every lane
// takes the CP channel groups t, t+4, t+8 (of 10 groups of 4 channels, 16
// bytes a tap, 6 gathers a group; a quad's lanes read 64 contiguous bytes
// of a line), all independent. The quad's partial d_x are summed with two
// xor shuffles (a fixed order, so the same bits every call), the optional
// d_x of the PE (K2's) is added, and lane t writes coordinate t. d_embed
// is read points-minor: a warp's 8 points are 32 contiguous bytes a row.
// Precision: float32.

#include "common.cuh"

namespace mf {

constexpr int K4_THREADS = 128;              // 4 lanes a point
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

constexpr int K3_THREADS = 256;
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_DE_LD = 33;                 // [CCP][33] per warp, no conflicts
constexpr int K3_DE_WARP = CCP * K3_DE_LD;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Sum v over each run of lanes with equal keys (a segmented inclusive scan
// over the warp). Runs are contiguous lanes: a ray's samples sit in
// consecutive lanes and enter each cell once, so a warp's lanes that share
// a cell form one run (two rays in one warp may give a cell two runs,
// which only costs an atomic). Returns true on the last lane of its run,
// which then holds the run's sum.
__device__ __forceinline__ bool warp_run_sum(int key, float4& v, int lane) {
  const int prev = __shfl_up_sync(FULL_MASK, key, 1);
  const unsigned heads = __ballot_sync(FULL_MASK, lane == 0 || prev != key);
  if (heads != FULL_MASK) {                  // warp-uniform
    const int start = 31 - __clz(heads & (FULL_MASK >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float x = __shfl_up_sync(FULL_MASK, v.x, d);
      const float y = __shfl_up_sync(FULL_MASK, v.y, d);
      const float z = __shfl_up_sync(FULL_MASK, v.z, d);
      const float w = __shfl_up_sync(FULL_MASK, v.w, d);
      if (lane - d >= start) {
        v.x += x; v.y += y; v.z += z; v.w += w;
      }
    }
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

// The fixed-point scale 2^k of one accumulator: the largest power of two
// with n * bound * 2^k < 2^62 (1 where the bound is 0 or not finite).
__device__ __forceinline__ float fixed_scale(unsigned bound_bits, float sq,
                                             int n) {
  const double total = (double)__uint_as_float(bound_bits) * sq * (double)n;
  if (!(total > 0.0) || !(total < 1e300)) return 1.0f;
  int e;
  frexp(total, &e);                        // total < 2^e
  return ldexpf(1.0f, max(-120, min(120, 62 - e)));
}

__device__ __forceinline__ void add_fixed(unsigned long long* dst, float v,
                                          float scale) {
  const long long q = __float2ll_rn(v * scale);
  if (q != 0) atomicAdd(dst, (unsigned long long)q);
}

__device__ __forceinline__ void add4_fixed(unsigned long long* dst, float4 v,
                                           float scale) {
  add_fixed(dst, v.x, scale);
  add_fixed(dst + 1, v.y, scale);
  add_fixed(dst + 2, v.z, scale);
  add_fixed(dst + 3, v.w, scale);
}

// Plane gradient of one plane at taps (u, v): one run-summed fixed-point
// add per run of lanes that share a cell, per tap.
template <int R>
__device__ __forceinline__ void scatter_plane(unsigned long long* dP,
                                              const Tap& u, const Tap& v,
                                              float4 g, bool ok, int lane,
                                              float scale) {
  const float wu[2] = {1.0f - u.w, u.w}, wv[2] = {1.0f - v.w, v.w};
  const int iu[2] = {u.i0, u.i1}, iv[2] = {v.i0, v.i1};
  const bool hu[2] = {ok, ok && u.has_next}, hv[2] = {true, v.has_next};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const bool valid = hu[a] && hv[b];
      const int key = valid ? iu[a] * R + iv[b] : -1;
      const float w = valid ? wu[a] * wv[b] : 0.f;
      float4 val = make_float4(w * g.x, w * g.y, w * g.z, w * g.w);
      if (warp_run_sum(key, val, lane) && key >= 0)
        add4_fixed(dP + key * FEAT, val, scale);
    }
  }
}

template <int R>
__device__ __forceinline__ void scatter_scale(unsigned long long* dS,
                                              const float x[3], float4 g,
                                              bool ok, int lane, float scale) {
  Tap t[3] = {make_tap<R>(x[0]), make_tap<R>(x[1]), make_tap<R>(x[2])};
  const int RR = R * R * FEAT;
  scatter_plane<R>(dS, t[0], t[1], g, ok, lane, scale);
  scatter_plane<R>(dS + RR, t[0], t[2], g, ok, lane, scale);
  scatter_plane<R>(dS + 2 * RR, t[1], t[2], g, ok, lane, scale);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 lerp4(float4 lo, float4 hi, float w) {
  return make_float4((1.0f - w) * lo.x + w * hi.x, (1.0f - w) * lo.y + w * hi.y,
                     (1.0f - w) * lo.z + w * hi.z, (1.0f - w) * lo.w + w * hi.w);
}

// Flush a CP run accumulator (channels c..c+3 of cell `key` on one line).
__device__ __forceinline__ void cp_run_add(unsigned long long* L, int key,
                                           int c, float4& acc, int next_key,
                                           float scale) {
  if (key != next_key) {
    if (key >= 0) add4_fixed(L + key * CCP + c, acc, scale);
    acc = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The accumulators: planes of both scales, then the CP lines (int64).
constexpr int K3_S0 = 3 * R0 * R0 * FEAT;
constexpr int K3_S1 = 3 * R1 * R1 * FEAT;
constexpr int K3_CP = 3 * RCP * CCP;
constexpr int K3_ACC = K3_S0 + K3_S1 + K3_CP;
constexpr int K3_MAX_THREADS = 256;

// max |d_embed| over the plane rows (mx[0]) and the CP rows (mx[1]), and
// max |cp| (mx[2]), as float bit patterns (non-negative floats order as
// unsigned integers, and a max does not depend on the order).
__global__ void __launch_bounds__(K3_MAX_THREADS)
    k3_absmax_kernel(const float* __restrict__ d_embed,
                     const float* __restrict__ cp, int N,
                     unsigned* __restrict__ mx) {
  const int row = blockIdx.y;
  const float* r = d_embed + (size_t)row * N;
  float m = 0.f;
  for (int n = blockIdx.x * K3_MAX_THREADS + threadIdx.x; n < N;
       n += gridDim.x * K3_MAX_THREADS)
    m = fmaxf(m, fabsf(r[n]));
  float mc = 0.f;
  if (row == 0)
    for (int i = blockIdx.x * K3_MAX_THREADS + threadIdx.x; i < K3_CP;
         i += gridDim.x * K3_MAX_THREADS)
      mc = fmaxf(mc, fabsf(cp[i]));
  for (int d = 16; d > 0; d >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, d));
    mc = fmaxf(mc, __shfl_xor_sync(FULL_MASK, mc, d));
  }
  if (threadIdx.x % 32 == 0) {
    atomicMax(mx + (row < 2 * FEAT ? 0 : 1), __float_as_uint(m));
    if (row == 0) atomicMax(mx + 2, __float_as_uint(mc));
  }
}

// A warp takes 32 consecutive points. Plane part: a lane per point; per
// tap the lanes that share a cell sum their float4 in registers and the
// run's last lane adds it. CP part, channel-parallel: lanes 0..29 are
// (line a = lane / 10, channels 4q..4q+3, q = lane % 10); the warp walks
// its 32 points in order and each lane keeps a running sum for its line's
// lower and upper cell, added when the cell changes, so a warp's CP adds
// land on 320 contiguous bytes of a line.
__global__ void __launch_bounds__(K3_THREADS)
    plane_bwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ d_embed,
                     const float* __restrict__ cp, int N,
                     const unsigned* __restrict__ mx,
                     unsigned long long* __restrict__ acc) {
  __shared__ float k3_de[K3_WARPS * K3_DE_WARP];   // 42 KB
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* dE = k3_de + warp * K3_DE_WARP;
  const size_t S = N;
  const int n_tiles = (N + 31) / 32;
  const int a = lane / 10, q = lane % 10;
  const float cmax = __uint_as_float(mx[2]);
  const float scale_p = fixed_scale(mx[0], 1.0f, N);
  const float scale_c = fixed_scale(mx[1], cmax * cmax, N);
  unsigned long long* d_s0 = acc;
  unsigned long long* d_s1 = acc + K3_S0;
  unsigned long long* L = acc + K3_S0 + K3_S1 + (size_t)a * RCP * CCP;
  for (int tile = blockIdx.x * K3_WARPS + warp; tile < n_tiles;
       tile += gridDim.x * K3_WARPS) {
    const int n = tile * 32 + lane;
    const bool ok = n < N;
    const float xp[3] = {ok ? x[n] : 0.5f, ok ? x[S + n] : 0.5f,
                         ok ? x[2 * S + n] : 0.5f};
    float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0;
    if (ok) {
      g0 = make_float4(d_embed[n], d_embed[S + n], d_embed[2 * S + n],
                       d_embed[3 * S + n]);
      g1 = make_float4(d_embed[4 * S + n], d_embed[5 * S + n],
                       d_embed[6 * S + n], d_embed[7 * S + n]);
    }
    scatter_scale<R0>(d_s0, xp, g0, ok, lane, scale_p);
    scatter_scale<R1>(d_s1, xp, g1, ok, lane, scale_p);

    // the warp's CP cotangents, [channel][point] (coalesced reads)
    for (int r = 0; r < CCP; ++r)
      dE[r * K3_DE_LD + lane] = ok ? d_embed[(size_t)(2 * FEAT + r) * S + n] : 0.f;
    __syncwarp();
    const int nv = min(32, N - tile * 32);
    float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
    int key0 = -1, key1 = -1;
    for (int j = 0; j < nv; ++j) {
      const float xj[3] = {__shfl_sync(FULL_MASK, xp[0], j),
                           __shfl_sync(FULL_MASK, xp[1], j),
                           __shfl_sync(FULL_MASK, xp[2], j)};
      if (lane >= 30) continue;
      const int c = 4 * q;
      Tap t[3];
      float4 f[3];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        t[b] = make_tap<RCP>(xj[b]);
        const float* Lb = cp + (size_t)b * RCP * CCP;
        f[b] = lerp4(ld4(Lb + t[b].i0 * CCP + c), ld4(Lb + t[b].i1 * CCP + c),
                     t[b].w);
      }
      const float4 others = a == 0 ? mul4(f[1], f[2])
                            : a == 1 ? mul4(f[0], f[2]) : mul4(f[0], f[1]);
      const float4 gc = make_float4(dE[c * K3_DE_LD + j],
                                    dE[(c + 1) * K3_DE_LD + j],
                                    dE[(c + 2) * K3_DE_LD + j],
                                    dE[(c + 3) * K3_DE_LD + j]);
      const float4 da = mul4(gc, others);
      const Tap ta = a == 0 ? t[0] : a == 1 ? t[1] : t[2];
      cp_run_add(L, key0, c, acc0, ta.i0, scale_c);
      key0 = ta.i0;
      acc0 = f4_axpy(1.0f - ta.w, da, acc0);
      if (ta.has_next) {
        cp_run_add(L, key1, c, acc1, ta.i1, scale_c);
        key1 = ta.i1;
        acc1 = f4_axpy(ta.w, da, acc1);
      }
    }
    if (lane < 30) {
      cp_run_add(L, key0, 4 * q, acc0, -1, scale_c);
      cp_run_add(L, key1, 4 * q, acc1, -1, scale_c);
    }
    __syncwarp();                            // dE is rewritten next tile
  }
}

// The fixed-point totals to float32 (exact power-of-two unscaling in
// double, one rounding).
__global__ void __launch_bounds__(K3_MAX_THREADS)
    k3_finish_kernel(const unsigned long long* __restrict__ acc,
                     const unsigned* __restrict__ mx, int N,
                     float* __restrict__ d_s0, float* __restrict__ d_s1,
                     float* __restrict__ d_cp) {
  const int i = blockIdx.x * K3_MAX_THREADS + threadIdx.x;
  if (i >= K3_ACC) return;
  const float cmax = __uint_as_float(mx[2]);
  const bool plane = i < K3_S0 + K3_S1;
  const double inv = 1.0 / (double)(plane ? fixed_scale(mx[0], 1.0f, N)
                                          : fixed_scale(mx[1], cmax * cmax, N));
  const float v = (float)((double)(long long)acc[i] * inv);
  if (i < K3_S0) d_s0[i] = v;
  else if (plane) d_s1[i - K3_S0] = v;
  else d_cp[i - K3_S0 - K3_S1] = v;
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

// d_x_pe (optional, [3, N]) is added to the result.
__global__ void __launch_bounds__(K4_THREADS)
    x_bwd_kernel(const float* __restrict__ x,
                 const float* __restrict__ d_embed,
                 const float* __restrict__ s0, const float* __restrict__ s1,
                 const float* __restrict__ cp, int N,
                 const float* __restrict__ d_x_pe, float* __restrict__ d_x) {
  const int tid = blockIdx.x * K4_THREADS + threadIdx.x;
  const int n = tid >> 2, t = tid & 3;
  const size_t S = N;
  // lanes past the end compute the last point again (they take part in
  // the shuffles) and store nothing
  const int nc = min(n, N - 1);
  const float xp[3] = {x[nc], x[S + nc], x[2 * S + nc]};
  float dx[3] = {0.f, 0.f, 0.f};
  if (t < 3) {
    // plane t of both scales, over axes (u, v) = (0, 1), (0, 2), (1, 2)
    const float xu = t == 2 ? xp[1] : xp[0], xv = t == 0 ? xp[1] : xp[2];
    const float* de = d_embed + nc;
    const float4 g0 = make_float4(de[0], de[S], de[2 * S], de[3 * S]);
    const float4 g1 = make_float4(de[4 * S], de[5 * S], de[6 * S], de[7 * S]);
    float du0, dv0, du1, dv1;
    plane_dx<R0>(s0 + t * R0 * R0 * FEAT, make_tap<R0>(xu), make_tap<R0>(xv),
                 g0, du0, dv0);
    plane_dx<R1>(s1 + t * R1 * R1 * FEAT, make_tap<R1>(xu), make_tap<R1>(xv),
                 g1, du1, dv1);
    const float du = du0 + du1, dv = dv0 + dv1;
    dx[0] = t < 2 ? du : 0.f;
    dx[1] = t == 0 ? dv : t == 2 ? du : 0.f;
    dx[2] = t >= 1 ? dv : 0.f;
  }

  const Tap tp[3] = {make_tap<RCP>(xp[0]), make_tap<RCP>(xp[1]),
                     make_tap<RCP>(xp[2])};
  float dcp[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int c = 4 * (t + 4 * i);           // channel group t + 4 i
    if (c >= CCP) continue;
    float4 f[3], df[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* L = cp + (size_t)a * RCP * CCP + c;
      const float4 lo = ld4(L + tp[a].i0 * CCP);
      const float4 hi = ld4(L + tp[a].i1 * CCP);
      f[a] = lerp4(lo, hi, tp[a].w);
      df[a] = sub4(tp[a].has_next ? hi : make_float4(0.f, 0.f, 0.f, 0.f), lo);
    }
    const float* de = d_embed + (size_t)(2 * FEAT + c) * S + nc;
    const float4 gc = make_float4(de[0], de[S], de[2 * S], de[3 * S]);
    dcp[0] += dot4(mul4(gc, df[0]), mul4(f[1], f[2]));
    dcp[1] += dot4(mul4(gc, df[1]), mul4(f[0], f[2]));
    dcp[2] += dot4(mul4(gc, df[2]), mul4(f[0], f[1]));
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float v = dx[a] + dcp[a] * (float)(RCP - 1);
    v += __shfl_xor_sync(FULL_MASK, v, 1);
    v += __shfl_xor_sync(FULL_MASK, v, 2);
    dx[a] = v;
  }
  if (n < N && t < 3) {
    float v = t == 0 ? dx[0] : t == 1 ? dx[1] : dx[2];
    if (d_x_pe) v += d_x_pe[t * S + n];
    d_x[t * S + n] = v;
  }
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

extern "C" int mf_plane_backward_acc_size() { return K3_ACC; }

// acc: K3_ACC zeroed int64 accumulators, mx: 3 zeroed unsigned ints.
extern "C" int mf_plane_backward(const float* x, const float* d_embed,
                                 const float* cp, int n, float* d_s0,
                                 float* d_s1, float* d_cp, void* acc,
                                 void* mx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* a = (unsigned long long*)acc;
  unsigned* m = (unsigned*)mx;
  if (n > 0) {
    const int mblocks = (n + K3_MAX_THREADS - 1) / K3_MAX_THREADS;
    const dim3 mgrid(mblocks < 64 ? mblocks : 64, EMB);
    k3_absmax_kernel<<<mgrid, K3_MAX_THREADS, 0, st>>>(d_embed, cp, n, m);
    const int grid = ((n + 31) / 32 + K3_WARPS - 1) / K3_WARPS;
    plane_bwd_kernel<<<grid, K3_THREADS, 0, st>>>(x, d_embed, cp, n, m, a);
  }
  k3_finish_kernel<<<(K3_ACC + K3_MAX_THREADS - 1) / K3_MAX_THREADS,
                     K3_MAX_THREADS, 0, st>>>(a, m, n > 0 ? n : 1, d_s0,
                                              d_s1, d_cp);
  return (int)cudaGetLastError();
}

// d_x_pe: null, or [3, N] added to the result.
extern "C" int mf_x_backward(const float* x, const float* d_embed,
                             const float* s0, const float* s1,
                             const float* cp, int n, const float* d_x_pe,
                             float* d_x, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int grid = (int)(((size_t)n * 4 + K4_THREADS - 1) / K4_THREADS);
  x_bwd_kernel<<<grid, K4_THREADS, 0, (cudaStream_t)stream>>>(
      x, d_embed, s0, s1, cp, n, d_x_pe, d_x);
  return (int)cudaGetLastError();
}
