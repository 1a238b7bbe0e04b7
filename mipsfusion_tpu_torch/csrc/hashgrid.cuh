// H1-H3: the multiresolution hash encoding (Mueller et al., Instant Neural
// Graphics Primitives, SIGGRAPH 2022, section 3), MIPS-Fusion's own field,
// templates over a hash shape (common.cuh HashShape), instantiated by
// shape.cu at that shape.
//
// They replace no TPU kernel: the JAX package builds the hash grid from XLA
// operations (mipsfusion_tpu/ops/encoding.py), as the port's plain version
// does in torch (ops/encoding.py _hash_forward, _hash_backward: on the card
// dozens of elementwise kernels over [8, L, n] int64 corner tables, which
// took most of a frame). Each kernel follows that definition exactly:
//  * level l: scale s_l and resolution r_l (the plain version's float32 and
//    int tables, passed by value); pos = x s_l + 0.5 rounded after each
//    operation (no fused multiply-add), the corners floor(pos) + {0, 1}^3
//    with per-axis weights 1 - f and f, f = pos - floor(pos), a corner's
//    weight (w_x w_y) w_z, corner 4 i + 2 j + k = (x_i, y_j, z_k);
//  * a corner's row: on the dense levels (r_l^3 <= T, a prefix) x + y r +
//    z r^2 of the corner clamped to [0, r - 1]; above them the spatial hash
//    x 1 ^ y 2654435761 ^ z 805459861 in uint32 arithmetic, masked to
//    T - 1 (a negative corner keeps its two's-complement bits).
//
// H1 hash_fwd_kernel: x [3, N] -> embed [2 L, N] (level l in rows 2 l and
// 2 l + 1), points-minor as K1 and K2 take it. A thread takes a (point,
// level); a block's 256 points are consecutive and its level is
// blockIdx.y, so the launch walks the levels in order (a level's rows stay
// in L2 while its blocks run: 7 MB for the nine dense levels together,
// 4 MB for a hashed one at 2^19 rows) and each embed row is written in
// whole sectors. The 8 corners are blended in the plain version's order.
// Bound: latency; what it costs is 8 independent 8-byte gathers a (point,
// level), 25 M at BA's 195,000 points; its bytes are x in, the embed out.
//
// H2 hash_table_bwd_kernel: the table gradient, sum over points and
// corners of g w into the corner's row. Each share g w is formed in
// float32 as the plain version forms it, multiplied by the fixed-point
// scale 2^(61 - e) (2^e bounds the largest column sum of |g|, so no
// entry's total passes 2^61; the wrapper takes it on the device), rounded
// to an int64 and added with a 64-bit integer atomic. Integer adds
// commute, so the result has the same bits whatever order the atomics take
// and equals the plain version's index_add_ of the same integers. A warp
// first sums the shares of a run of lanes with the same row (a ray's
// samples sit in consecutive lanes and share the coarse levels' cells),
// exact in int64, so it changes only the number of atomics.
// hash_table_bwd_finish_kernel converts once: the sum over the scale in
// double, rounded to float32, as the plain version converts. The
// accumulator (8 B a table entry: 134 MB at 2^19 rows, beyond L2) is
// zeroed, atomically added into and read once; its atomics are the limit.
//
// H3 hash_x_bwd_kernel: d_x [3, N] = d_x_pe (K2's d_x through the PE, if
// given) + sum over levels of s_l d out / d f, with d out / d f_d the sum
// over corners of (g . feature) times the other two axes' weights, signed
// by the corner's side on axis d. A thread takes a point and walks the
// levels. GO needs it alone, without H2.
// Precision: float32 throughout; the table gradient in int64 fixed point.

#pragma once
#include "common.cuh"

namespace mf {
namespace {                                  // one copy per shape's object

constexpr int HASH_THREADS = 256;
constexpr int HASH_MAX_L = 16;
constexpr unsigned HASH_FULL = 0xffffffffu;
constexpr uint32_t HASH_P1 = 2654435761u, HASH_P2 = 805459861u;

// The grid's levels, passed by value (a CUDA graph keeps them with the
// launch): the per-level scale and resolution, the dense levels, T.
struct HashLevels {
  float scale[HASH_MAX_L];
  int res[HASH_MAX_L];
  int n_dense;
  int log2_t;
};

static inline HashLevels make_levels(int n_levels, int log2_t, int n_dense,
                                     const float* scales, const int* res) {
  HashLevels lv{};
  for (int l = 0; l < n_levels && l < HASH_MAX_L; ++l) {
    lv.scale[l] = scales[l];
    lv.res[l] = res[l];
  }
  lv.n_dense = n_dense;
  lv.log2_t = log2_t;
  return lv;
}

// A point's 8 corners on one level: rows of the level's table and the
// per-axis weights (lower, upper).
struct HashCorners {
  int row[8];
  float wa[3][2];
};

__device__ __forceinline__ void hash_corners(const HashLevels& lv, int l,
                                             const float x[3],
                                             HashCorners& c) {
  const float s = lv.scale[l];
  int g0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], s), 0.5f);
    const float fl = floorf(pos);
    const float fr = __fsub_rn(pos, fl);
    g0[d] = (int)fl;
    c.wa[d][0] = __fsub_rn(1.0f, fr);
    c.wa[d][1] = fr;
  }
  if (l < lv.n_dense) {
    const int r = lv.res[l];
    int cx[2], cy[2], cz[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cx[i] = min(max(g0[0] + i, 0), r - 1);
      cy[i] = min(max(g0[1] + i, 0), r - 1) * r;
      cz[i] = min(max(g0[2] + i, 0), r - 1) * (r * r);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      c.row[k] = cx[k >> 2] + cy[(k >> 1) & 1] + cz[k & 1];
  } else {
    const uint32_t mask = (1u << lv.log2_t) - 1u;
    uint32_t hx[2], hy[2], hz[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hx[i] = (uint32_t)(g0[0] + i);
      hy[i] = (uint32_t)(g0[1] + i) * HASH_P1;
      hz[i] = (uint32_t)(g0[2] + i) * HASH_P2;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      c.row[k] = (int)((hx[k >> 2] ^ hy[(k >> 1) & 1] ^ hz[k & 1]) & mask);
  }
}

// Corner k's trilinear weight, (w_x w_y) w_z.
__device__ __forceinline__ float hash_weight(const HashCorners& c, int k) {
  return __fmul_rn(__fmul_rn(c.wa[0][k >> 2], c.wa[1][(k >> 1) & 1]),
                   c.wa[2][k & 1]);
}

__device__ __forceinline__ void hash_point(const float* __restrict__ x,
                                           size_t S, int n, float xp[3]) {
  xp[0] = x[n];
  xp[1] = x[S + n];
  xp[2] = x[2 * S + n];
}

// ----------------------------------------------------------------- H1 ----

template <class Sh>
__global__ void __launch_bounds__(HASH_THREADS)
    hash_fwd_kernel(const float* __restrict__ x, int N,
                    const float2* __restrict__ table, HashLevels lv,
                    float* __restrict__ embed) {
  const int n = blockIdx.x * HASH_THREADS + threadIdx.x;
  const int l = blockIdx.y;
  if (n >= N) return;
  const size_t S = N;
  float xp[3];
  hash_point(x, S, n, xp);
  HashCorners c;
  hash_corners(lv, l, xp, c);
  const float2* tl = table + ((size_t)l << lv.log2_t);
  float2 f[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = __ldg(tl + c.row[k]);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = hash_weight(c, k);
    a0 = __fadd_rn(a0, __fmul_rn(f[k].x, w));
    a1 = __fadd_rn(a1, __fmul_rn(f[k].y, w));
  }
  embed[(size_t)(2 * l) * S + n] = a0;
  embed[(size_t)(2 * l + 1) * S + n] = a1;
}

// ----------------------------------------------------------------- H2 ----

// Sum (v0, v1) over each run of lanes with equal keys (a segmented
// inclusive scan over the warp, in int64: exact). Returns true on the last
// lane of its run, which then holds the run's sums.
__device__ __forceinline__ bool hash_run_sum(int key, long long& v0,
                                             long long& v1, int lane) {
  const int prev = __shfl_up_sync(HASH_FULL, key, 1);
  const unsigned heads = __ballot_sync(HASH_FULL, lane == 0 || prev != key);
  if (heads != HASH_FULL) {                  // warp-uniform
    const int start = 31 - __clz(heads & (HASH_FULL >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long a = __shfl_up_sync(HASH_FULL, v0, d);
      const long long b = __shfl_up_sync(HASH_FULL, v1, d);
      if (lane - d >= start) {
        v0 += a;
        v1 += b;
      }
    }
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

// Every lane of a warp takes part in the run sums: a lane past N carries
// key -1 and nothing to add.
template <class Sh>
__global__ void __launch_bounds__(HASH_THREADS)
    hash_table_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ g, int N, HashLevels lv,
                          const float* __restrict__ scale,
                          unsigned long long* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * HASH_THREADS + threadIdx.x;
  const int l = blockIdx.y;
  const bool ok = n < N;
  const size_t S = N;
  float xp[3];
  hash_point(x, S, ok ? n : 0, xp);
  const float g0 = ok ? g[(size_t)(2 * l) * S + n] : 0.f;
  const float g1 = ok ? g[(size_t)(2 * l + 1) * S + n] : 0.f;
  const float sc = *scale;
  HashCorners c;
  hash_corners(lv, l, xp, c);
  unsigned long long* al = acc + ((size_t)l << lv.log2_t) * 2;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = hash_weight(c, k);
    long long v0 = __float2ll_rn(__fmul_rn(__fmul_rn(g0, w), sc));
    long long v1 = __float2ll_rn(__fmul_rn(__fmul_rn(g1, w), sc));
    const int key = ok ? c.row[k] : -1;
    if (hash_run_sum(key, v0, v1, lane) && key >= 0) {
      if (v0) atomicAdd(al + 2 * key, (unsigned long long)v0);
      if (v1) atomicAdd(al + 2 * key + 1, (unsigned long long)v1);
    }
  }
}

// d_table = acc / scale, in double, rounded once to float32.
template <class Sh>
__global__ void hash_table_bwd_finish_kernel(const long long* __restrict__ acc,
                                             const float* __restrict__ scale,
                                             long long n,
                                             float* __restrict__ out) {
  const double sc = (double)*scale;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    out[i] = (float)((double)acc[i] / sc);
}

// ----------------------------------------------------------------- H3 ----

template <class Sh>
__global__ void __launch_bounds__(HASH_THREADS)
    hash_x_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ g, int N,
                      const float2* __restrict__ table, HashLevels lv,
                      const float* __restrict__ d_x_pe,
                      float* __restrict__ d_x) {
  const int n = blockIdx.x * HASH_THREADS + threadIdx.x;
  if (n >= N) return;
  const size_t S = N;
  float xp[3];
  hash_point(x, S, n, xp);
  float dx[3] = {0.f, 0.f, 0.f};
#pragma unroll 2
  for (int l = 0; l < Sh::L; ++l) {
    HashCorners c;
    hash_corners(lv, l, xp, c);
    const float2* tl = table + ((size_t)l << lv.log2_t);
    const float g0 = g[(size_t)(2 * l) * S + n];
    const float g1 = g[(size_t)(2 * l + 1) * S + n];
    float dw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float2 f = __ldg(tl + c.row[k]);
      dw[k] = __fadd_rn(__fmul_rn(f.x, g0), __fmul_rn(f.y, g1));
    }
    // t_d[s]: the corners on side s of axis d, each times the other two
    // axes' weights; d out / d f_d = t_d[1] - t_d[0]
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int a = d == 0 ? 1 : 0, b = d == 2 ? 1 : 2;   // the other axes
      float t[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            int side[3];
            side[d] = s;
            side[a] = i;
            side[b] = j;
            const int k = 4 * side[0] + 2 * side[1] + side[2];
            sum = __fadd_rn(sum, __fmul_rn(__fmul_rn(dw[k], c.wa[a][i]),
                                           c.wa[b][j]));
          }
        t[s] = sum;
      }
      dx[d] = __fadd_rn(dx[d], __fmul_rn(__fsub_rn(t[1], t[0]), lv.scale[l]));
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d)
    d_x[d * S + n] = d_x_pe ? __fadd_rn(d_x_pe[d * S + n], dx[d]) : dx[d];
}

// ---------------------------------------------------------- launches ----

template <class Sh>
int hash_forward(const float* x, int n, const float* table,
                 const HashLevels& lv, float* embed, cudaStream_t st) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + HASH_THREADS - 1) / HASH_THREADS, Sh::L);
  hash_fwd_kernel<Sh><<<grid, HASH_THREADS, 0, st>>>(
      x, n, reinterpret_cast<const float2*>(table), lv, embed);
  return (int)cudaGetLastError();
}

// acc: scratch of L T 2 int64 (zeroed here); d_table [L, T, 2] is written
// whole, zeros where no point reached.
template <class Sh>
int hash_table_backward(const float* x, const float* g, int n,
                        const HashLevels& lv, const float* scale, void* acc,
                        float* d_table, cudaStream_t st) {
  const long long size = (long long)Sh::L * 2 << lv.log2_t;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)size * 8, st);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    const dim3 grid((n + HASH_THREADS - 1) / HASH_THREADS, Sh::L);
    hash_table_bwd_kernel<Sh><<<grid, HASH_THREADS, 0, st>>>(
        x, g, n, lv, scale, reinterpret_cast<unsigned long long*>(acc));
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const long long blocks = (size + 255) / 256;
  hash_table_bwd_finish_kernel<Sh><<<(int)(blocks < 4096 ? blocks : 4096),
                                     256, 0, st>>>(
      reinterpret_cast<const long long*>(acc), scale, size, d_table);
  return (int)cudaGetLastError();
}

template <class Sh>
int hash_x_backward(const float* x, const float* g, int n, const float* table,
                    const HashLevels& lv, const float* d_x_pe, float* d_x,
                    cudaStream_t st) {
  if (n <= 0) return (int)cudaSuccess;
  hash_x_bwd_kernel<Sh><<<(n + HASH_THREADS - 1) / HASH_THREADS,
                          HASH_THREADS, 0, st>>>(
      x, g, n, reinterpret_cast<const float2*>(table), lv, d_x_pe, d_x);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mf

// The C entry points of H1-H3 at hash shape SH, each named <name>_SUFFIX.
// Every one takes the grid's levels as the plain version's tables: log2 T,
// the dense levels, the L scales (float32) and resolutions (int32) on the
// host, read during the call.
#define MF_HASH_ENTRY_POINTS(SH, SUFFIX)                                      \
  extern "C" int mf_hash_embed_size_##SUFFIX() { return SH::EMB; }           \
  extern "C" int mf_hash_forward_##SUFFIX(                                   \
      const float* x, int n, const float* table, int log2_t, int n_dense,    \
      const float* scales, const int* res, float* embed, void* stream) {     \
    return mf::hash_forward<SH>(                                             \
        x, n, table, mf::make_levels(SH::L, log2_t, n_dense, scales, res),   \
        embed, (cudaStream_t)stream);                                        \
  }                                                                          \
  extern "C" int mf_hash_table_backward_##SUFFIX(                            \
      const float* x, const float* g, int n, int log2_t, int n_dense,        \
      const float* scales, const int* res, const float* scale, void* acc,    \
      float* d_table, void* stream) {                                        \
    return mf::hash_table_backward<SH>(                                      \
        x, g, n, mf::make_levels(SH::L, log2_t, n_dense, scales, res),       \
        scale, acc, d_table, (cudaStream_t)stream);                          \
  }                                                                          \
  extern "C" int mf_hash_x_backward_##SUFFIX(                                \
      const float* x, const float* g, int n, const float* table, int log2_t, \
      int n_dense, const float* scales, const int* res, const float* d_x_pe, \
      float* d_x, void* stream) {                                            \
    return mf::hash_x_backward<SH>(                                          \
        x, g, n, table, mf::make_levels(SH::L, log2_t, n_dense, scales, res), \
        d_x_pe, d_x, (cudaStream_t)stream);                                  \
  }
