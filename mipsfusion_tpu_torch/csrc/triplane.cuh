// K0: the Triplane+CP encoding alone, K3: plane / CP-line gradients, and
// K4: coordinate gradients, each a template over the field shape
// (common.cuh FieldShape), instantiated once per shape by shape.cu.
//
// K0 replaces mipsfusion_tpu/ops/triplane_pallas.py _fused_forward
// (_make_fwd_kernel), the forward of triplane_encode_pallas. The TPU held
// the bf16 planes and CP lines whole in VMEM and built each lookup as a
// one-hot matmul over a 2048-point block. K0 writes the [N, E] row layout
// of triplane_encode_pallas: per point one float4 part per plane scale
// (the sum of its three bilinear plane lookups), then one per group of 4
// CP channels (the product of three linear line lookups): 12 parts at the
// flagship's E = 48, 11 at E = 44, 13 at E = 52.
// Bound: bytes (12 B in, 4E B out a point: 0.012 ms at 195,000 points at
// the flagship). The first design (a thread a point, every tap an L2
// gather) reached 17% of it: ~50 sectors a point crossed from L2, 6-9
// times the bytes the bound counts, and a warp's stores half-filled
// their sectors.
// Design. The encode is cut into roles, one per plane scale and one for
// the CP lines. Persistent blocks, one an SM, each take one role;
// ops/_build.FieldShape.encode_plan splits the SMs across the roles in
// proportion to their tap reads, once per shape and card.
//  * A block stages its role's table in shared memory once, with bulk
//    copies that complete on an mbarrier, where it fits (k0_staged, a
//    fact of the shape): s0 48 KB, s1 and the CP lines 180-192 KB. The
//    768 KB third scale of the cp and fcl shapes does not fit; its taps
//    stay L2 gathers.
//  * A scale lane takes a point (12 taps). A CP lane takes a point's
//    group of 4 channels, point-major, so a point's groups sit on
//    neighbouring lanes: their taps read one contiguous stretch of each
//    line row, and a warp's stores fill whole sectors of the rows' CP
//    parts.
// Variants measured on the card (PERF.md section 6; the split between
// roles with tools/k0_plans.py): every tap from L2 (lanes over parts
// alone), only the CP lines or only the planes staged, the split moved
// between roles or by the plain count of taps, 256 / 768 /
// 1024 threads, 2-4 items a lane, the next item's point prefetched,
// streamed stores, the CP items split into groups 0-7 and the rest (no
// quarter-warp bank conflicts), and reading from L2 while the table
// arrives: none beat this one at the flagship's 195,000 points. Probes
// that take work away show what is left: with no lookups at all (the
// points read, the output written by the roles' 16- and 160-byte stores)
// it takes 80-90% of its time, about 1.7 times what PyTorch's zero_()
// takes to write the same bytes.
// The lookups are K1's (common.cuh scale_lookup, cp_lookup4, loading from
// shared memory here), so K0 and K1 share one interpolation, the
// upper-tap clamp included, and K0's output is K1's embed bit for bit.
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
// line's 32 or 40 channels, one add per run of a cell).
// Determinism: float atomics would make the summation order, and so the
// rounding, differ from run to run, and the SLAM loop's decisions amplify
// that. So each add goes to an int64 accumulator in fixed point with a
// power-of-two scale (one 64-bit integer atomic per channel); integer
// addition is associative, so every run gives the same bits. A first
// kernel takes max |d_embed| and max |cp| (an order-free max); the scale
// is the largest power of two at which N contributions of that size
// cannot overflow 2^62, which keeps the rounding error of a sum below
// N^2 / 2^62 of the largest contribution (8e-9 of it at N = 195,000),
// below float32 atomics' own. A last kernel converts to float32. The
// accumulator holds every plane of every scale, then the CP lines: 0.8 MB
// at the flagship, 2.4 MB with a 128 scale.
// Precision: float32 products and run sums, fixed-point totals.
//
// K4 replaces mipsfusion_tpu/ops/triplane_pallas.py _fused_backward_x
// (_make_bwd_x_kernel): d_x from the derivative taps of the plane and CP
// interpolation times (R-1). As the TPU kernel, the derivative is the tent
// derivative at the clamped coordinate, also for points outside [0, 1]
// (where the composite autodiff path gives 0), and at the upper clamp,
// where row i0+1 does not exist, it is -P[R-1]. Its bound is bytes (216 B
// a point in and out at the flagship); what it costs is 84 16-byte gathers
// a point from the tables in L1/L2, so the design keeps many of them in
// flight and few cache lines per load: the four lanes of a quad share a
// point. Lane t < 3 takes plane t (xy, xz, yz) of every scale (4 gathers a
// scale), and every lane takes the CP channel groups t, t+4, t+8 (of 8 or
// 10 groups of 4 channels, 16 bytes a tap, 6 gathers a group; a quad's
// lanes read 64 contiguous bytes of a line), all independent. The quad's
// partial d_x are summed with two xor shuffles (a fixed order, so the
// same bits every call), the optional d_x of the PE (K2's) is added, and
// lane t writes coordinate t. d_embed is read points-minor: a warp's 8
// points are 32 contiguous bytes a row.
// Precision: float32.

#pragma once
#include "common.cuh"

namespace mf {
namespace {                                  // one copy per shape's object

constexpr int K4_THREADS = 128;              // 4 lanes a point

// ----------------------------------------------------------------- K0 ----

constexpr int K0_THREADS = 512;
constexpr int K0_ROLES = 4;                  // scale 0, 1, 2, the CP lines
constexpr int K0_SMEM_MAX = 232448;          // a block's shared memory
constexpr int K0_BARRIER = 16;               // the staging mbarrier
constexpr int K0_CHUNK = 32768;              // bytes of one bulk copy

// Bytes of role r's table: scale r's three planes (0 for a third scale
// the shape does not have), then the CP lines.
template <class Sh>
__host__ __device__ constexpr int k0_table_bytes(int r) {
  return r == 0   ? 3 * Sh::R0 * Sh::R0 * FEAT * 4
         : r == 1 ? 3 * Sh::R1 * Sh::R1 * FEAT * 4
         : r == 2 ? (Sh::NS > 2 ? 3 * Sh::R2 * Sh::R2 * FEAT * 4 : 0)
                  : Sh::CP_SIZE * 4;
}

// Whether role r stages its table in shared memory: exactly where it fits
// beside the barrier (every table at the flagship; at cp and fcl all but
// the 786 KB third scale, whose taps stay L2 gathers).
template <class Sh>
__host__ __device__ constexpr bool k0_staged(int r) {
  return k0_table_bytes<Sh>(r) > 0 &&
         k0_table_bytes<Sh>(r) <= K0_SMEM_MAX - K0_BARRIER;
}

// The largest table a block stages: the table region of the dynamic
// shared memory, the barrier behind it.
template <class Sh>
__host__ __device__ constexpr int k0_table_max() {
  int m = 0;
  for (int r = 0; r < K0_ROLES; ++r)
    if (k0_staged<Sh>(r) && k0_table_bytes<Sh>(r) > m)
      m = k0_table_bytes<Sh>(r);
  return m;
}

template <class Sh>
__host__ __device__ constexpr int k0_smem_bytes() {
  return k0_table_max<Sh>() + K0_BARRIER;
}

// Blocks launched per role: role r owns the next blocks[r] blocks of the
// grid.
struct K0Plan {
  int blocks[K0_ROLES];
};

// Copy `bytes` of a table into shared memory: one thread issues bulk
// copies (the copy engine computes the addresses), which complete on an
// mbarrier behind the table that every thread then waits on.
__device__ __forceinline__ void k0_stage(const float* src, int bytes,
                                         unsigned char* smem, int bar_off) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned bar = (unsigned)__cvta_generic_to_shared(smem + bar_off);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes)
                 : "memory");
    const char* g = reinterpret_cast<const char*>(src);
    for (int off = 0; off < bytes; off += K0_CHUNK) {
      const int n = bytes - off < K0_CHUNK ? bytes - off : K0_CHUNK;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(dst + off),
          "l"(g + off), "r"(n), "r"(bar)
          : "memory");
    }
  }
  __syncthreads();                           // the barrier is initialised
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  } while (!done);
}

// The item i of a role: its point n and the embed part it fills. A scale
// role (S >= 0) has an item a point, part S; the CP role (S < 0) an item
// a point's group of 4 channels, point-major, so a point's groups sit on
// neighbouring lanes: their taps read one contiguous stretch of each line
// row, and a warp's stores fill whole sectors of the rows' CP parts.
template <class Sh, int S>
__device__ __forceinline__ void k0_item(unsigned i, unsigned& n,
                                        unsigned& part) {
  if constexpr (S >= 0) {
    n = i;
    part = S;
  } else {
    n = i / Sh::NCPG;
    part = Sh::NS + (i - n * Sh::NCPG);
  }
}

template <int R, class Ld>
struct ScaleLook {                           // part S: a scale's 3 planes
  const float* T;
  Ld ld;
  __device__ __forceinline__ float4 operator()(const float x[3],
                                               unsigned) const {
    return scale_lookup<R>(T, x, ld);
  }
};

template <class Sh, class Ld>
struct CpLook {                              // part NS + g: CP group g
  const float* L;
  Ld ld;
  __device__ __forceinline__ float4 operator()(const float x[3],
                                               unsigned part) const {
    return cp_lookup4<Sh>(L, x, 4 * (part - Sh::NS), ld);
  }
};

// Walk role S's items (S < 0: the CP role) on N points: block b of the
// role's nb blocks takes the tiles of K0_THREADS items b, b + nb, .., a
// lane an item.
template <class Sh, int S, class Look>
__device__ __forceinline__ void k0_walk(const float* __restrict__ x, int N,
                                        float* __restrict__ out, int b,
                                        int nb, Look look) {
  const unsigned items = S >= 0 ? N : (unsigned)N * Sh::NCPG;
  for (unsigned i = b * K0_THREADS + threadIdx.x; i < items;
       i += nb * K0_THREADS) {
    unsigned n, part;
    k0_item<Sh, S>(i, n, part);
    const float xp[3] = {x[3 * (size_t)n], x[3 * (size_t)n + 1],
                         x[3 * (size_t)n + 2]};
    *reinterpret_cast<float4*>(out + (size_t)n * Sh::EMB + FEAT * part) =
        look(xp, part);
  }
}

// Role R (0-2 a plane scale, 3 the CP lines) on block b of its nb, its
// taps read with Ld from the table T.
template <class Sh, int R, class Ld>
__device__ __forceinline__ void k0_walk_role(const float* x, const float* T,
                                             int N, float* out, int b,
                                             int nb) {
  if constexpr (R < 3) {
    constexpr int RES = R == 0 ? Sh::R0 : R == 1 ? Sh::R1 : Sh::R2;
    k0_walk<Sh, R>(x, N, out, b, nb, ScaleLook<RES, Ld>{T, {}});
  } else {
    k0_walk<Sh, -1>(x, N, out, b, nb, CpLook<Sh, Ld>{T, {}});
  }
}

// Role R with its table staged in shared memory where it fits, else read
// from L2.
template <class Sh, int R>
__device__ __forceinline__ void k0_role(const float* x, const float* T,
                                        int N, float* out, int b, int nb,
                                        unsigned char* smem) {
  if constexpr (k0_staged<Sh>(R)) {
    k0_stage(T, k0_table_bytes<Sh>(R), smem, k0_table_max<Sh>());
    k0_walk_role<Sh, R, SharedLd>(x, reinterpret_cast<const float*>(smem),
                                  N, out, b, nb);
  } else {
    k0_walk_role<Sh, R, GlobalLd>(x, T, N, out, b, nb);
  }
}

template <class Sh>
__global__ void __launch_bounds__(K0_THREADS, 1)
    encode_fwd_kernel(const float* __restrict__ x, Planes P, int N,
                      float* __restrict__ out, K0Plan plan) {
  extern __shared__ __align__(16) unsigned char k0_smem[];
  // this block's role and its index among the role's blocks
  int r = 0, b = blockIdx.x, nb = plan.blocks[0];
#pragma unroll
  for (int k = 0; k < K0_ROLES - 1; ++k)
    if (r == k && b >= plan.blocks[k]) {
      b -= plan.blocks[k];
      r = k + 1;
      nb = plan.blocks[k + 1];
    }
  if (r == 0) {
    k0_role<Sh, 0>(x, P.s[0], N, out, b, nb, k0_smem);
  } else if (r == 1) {
    k0_role<Sh, 1>(x, P.s[1], N, out, b, nb, k0_smem);
  } else if (r == 2) {
    if constexpr (Sh::NS > 2) k0_role<Sh, 2>(x, P.s[2], N, out, b, nb, k0_smem);
  } else {
    k0_role<Sh, 3>(x, P.cp, N, out, b, nb, k0_smem);
  }
}

constexpr int K3_THREADS = 256;
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_DE_LD = 33;                 // [CCP][33] per warp, no conflicts
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

// The plane gradients of one scale; g holds the point's 4 d_embed rows of
// that scale.
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

// Flush a CP run accumulator (channels c..c+3 of cell `key` on one line of
// CCP channels).
template <int CCP>
__device__ __forceinline__ void cp_run_add(unsigned long long* L, int key,
                                           int c, float4& acc, int next_key,
                                           float scale) {
  if (key != next_key) {
    if (key >= 0) add4_fixed(L + key * CCP + c, acc, scale);
    acc = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The accumulators (int64): the planes of every scale in order (Sh::PLANES
// words), then the CP lines (Sh::CP_SIZE).
constexpr int K3_MAX_THREADS = 256;

// Offset of scale s's planes in the accumulator (and in the gradients).
template <class Sh>
__host__ __device__ constexpr int k3_scale_off(int s) {
  return s == 0 ? 0
         : s == 1 ? 3 * FEAT * Sh::R0 * Sh::R0
                  : 3 * FEAT * (Sh::R0 * Sh::R0 + Sh::R1 * Sh::R1);
}

// max |d_embed| over the plane rows (mx[0]) and the CP rows (mx[1]), and
// max |cp| (mx[2]), as float bit patterns (non-negative floats order as
// unsigned integers, and a max does not depend on the order).
template <class Sh>
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
    for (int i = blockIdx.x * K3_MAX_THREADS + threadIdx.x; i < Sh::CP_SIZE;
         i += gridDim.x * K3_MAX_THREADS)
      mc = fmaxf(mc, fabsf(cp[i]));
  for (int d = 16; d > 0; d >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, d));
    mc = fmaxf(mc, __shfl_xor_sync(FULL_MASK, mc, d));
  }
  if (threadIdx.x % 32 == 0) {
    atomicMax(mx + (row < Sh::NS * FEAT ? 0 : 1), __float_as_uint(m));
    if (row == 0) atomicMax(mx + 2, __float_as_uint(mc));
  }
}

// A warp takes 32 consecutive points. Plane part: a lane per point; per
// tap the lanes that share a cell sum their float4 in registers and the
// run's last lane adds it. CP part, channel-parallel: with G = CCP / 4
// channel groups, lanes 0..3G-1 (30 lanes at 40 channels, 24 at 32) are
// (line a = lane / G, channels 4q..4q+3, q = lane % G); the warp walks its
// 32 points in order and each lane keeps a running sum for its line's
// lower and upper cell, added when the cell changes, so a warp's CP adds
// land on 4 CCP contiguous bytes of a line.
template <class Sh>
__global__ void __launch_bounds__(K3_THREADS)
    plane_bwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ d_embed,
                     const float* __restrict__ cp, int N,
                     const unsigned* __restrict__ mx,
                     unsigned long long* __restrict__ acc) {
  constexpr int RCP = Sh::RCP, CCP = Sh::CCP, G = Sh::NCPG;
  constexpr int DE_WARP = CCP * K3_DE_LD;
  __shared__ float k3_de[K3_WARPS * DE_WARP];      // 42 KB at 40 channels
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* dE = k3_de + warp * DE_WARP;
  const size_t S = N;
  const int n_tiles = (N + 31) / 32;
  const bool cp_lane = lane < 3 * G;
  const int a = cp_lane ? lane / G : 0, q = lane % G;
  const float cmax = __uint_as_float(mx[2]);
  const float scale_p = fixed_scale(mx[0], 1.0f, N);
  const float scale_c = fixed_scale(mx[1], cmax * cmax, N);
  unsigned long long* L = acc + Sh::PLANES + (size_t)a * RCP * CCP;
  for (int tile = blockIdx.x * K3_WARPS + warp; tile < n_tiles;
       tile += gridDim.x * K3_WARPS) {
    const int n = tile * 32 + lane;
    const bool ok = n < N;
    const float xp[3] = {ok ? x[n] : 0.5f, ok ? x[S + n] : 0.5f,
                         ok ? x[2 * S + n] : 0.5f};
    // scale s reads rows 4s..4s+3 of d_embed
    float4 g[Sh::NS];
#pragma unroll
    for (int s = 0; s < Sh::NS; ++s) {
      const float* r = d_embed + (size_t)(FEAT * s) * S + n;
      g[s] = ok ? make_float4(r[0], r[S], r[2 * S], r[3 * S])
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    scatter_scale<Sh::R0>(acc, xp, g[0], ok, lane, scale_p);
    scatter_scale<Sh::R1>(acc + k3_scale_off<Sh>(1), xp, g[1], ok, lane,
                          scale_p);
    if constexpr (Sh::NS > 2)
      scatter_scale<Sh::R2>(acc + k3_scale_off<Sh>(2), xp, g[2], ok, lane,
                            scale_p);

    // the warp's CP cotangents, [channel][point] (coalesced reads)
    for (int r = 0; r < CCP; ++r)
      dE[r * K3_DE_LD + lane] =
          ok ? d_embed[(size_t)(Sh::NS * FEAT + r) * S + n] : 0.f;
    __syncwarp();
    const int nv = min(32, N - tile * 32);
    float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
    int key0 = -1, key1 = -1;
    for (int j = 0; j < nv; ++j) {
      const float xj[3] = {__shfl_sync(FULL_MASK, xp[0], j),
                           __shfl_sync(FULL_MASK, xp[1], j),
                           __shfl_sync(FULL_MASK, xp[2], j)};
      if (!cp_lane) continue;
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
      cp_run_add<CCP>(L, key0, c, acc0, ta.i0, scale_c);
      key0 = ta.i0;
      acc0 = f4_axpy(1.0f - ta.w, da, acc0);
      if (ta.has_next) {
        cp_run_add<CCP>(L, key1, c, acc1, ta.i1, scale_c);
        key1 = ta.i1;
        acc1 = f4_axpy(ta.w, da, acc1);
      }
    }
    if (cp_lane) {
      cp_run_add<CCP>(L, key0, 4 * q, acc0, -1, scale_c);
      cp_run_add<CCP>(L, key1, 4 * q, acc1, -1, scale_c);
    }
    __syncwarp();                            // dE is rewritten next tile
  }
}

// The fixed-point totals to float32 (exact power-of-two unscaling in
// double, one rounding), into each scale's gradient and the CP lines'.
template <class Sh>
__global__ void __launch_bounds__(K3_MAX_THREADS)
    k3_finish_kernel(const unsigned long long* __restrict__ acc,
                     const unsigned* __restrict__ mx, int N, float* d_s0,
                     float* d_s1, float* d_s2, float* __restrict__ d_cp) {
  const int i = blockIdx.x * K3_MAX_THREADS + threadIdx.x;
  if (i >= Sh::PLANES + Sh::CP_SIZE) return;
  const float cmax = __uint_as_float(mx[2]);
  const bool plane = i < Sh::PLANES;
  const double inv = 1.0 / (double)(plane ? fixed_scale(mx[0], 1.0f, N)
                                          : fixed_scale(mx[1], cmax * cmax, N));
  const float v = (float)((double)(long long)acc[i] * inv);
  constexpr int O1 = k3_scale_off<Sh>(1), O2 = k3_scale_off<Sh>(2);
  if (i < O1) d_s0[i] = v;
  else if (Sh::NS == 2 ? plane : i < O2) d_s1[i - O1] = v;
  else if (plane) d_s2[i - O2] = v;
  else d_cp[i - Sh::PLANES] = v;
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

// (du, dv) of plane t of one scale of resolution R (planes S, d_embed rows
// de[0], de[S_], .. of that scale), added to du, dv.
template <int R>
__device__ __forceinline__ void scale_plane_dx(const float* S, int t,
                                               float xu, float xv,
                                               const float* de, size_t S_,
                                               float& du, float& dv) {
  const float4 g = make_float4(de[0], de[S_], de[2 * S_], de[3 * S_]);
  float a, b;
  plane_dx<R>(S + t * R * R * FEAT, make_tap<R>(xu), make_tap<R>(xv), g, a,
              b);
  du += a;
  dv += b;
}

// d_x_pe (optional, [3, N]) is added to the result.
template <class Sh>
__global__ void __launch_bounds__(K4_THREADS)
    x_bwd_kernel(const float* __restrict__ x,
                 const float* __restrict__ d_embed, Planes P, int N,
                 const float* __restrict__ d_x_pe, float* __restrict__ d_x) {
  constexpr int RCP = Sh::RCP, CCP = Sh::CCP;
  const int tid = blockIdx.x * K4_THREADS + threadIdx.x;
  const int n = tid >> 2, t = tid & 3;
  const size_t S = N;
  // lanes past the end compute the last point again (they take part in
  // the shuffles) and store nothing
  const int nc = min(n, N - 1);
  const float xp[3] = {x[nc], x[S + nc], x[2 * S + nc]};
  float dx[3] = {0.f, 0.f, 0.f};
  if (t < 3) {
    // plane t of every scale, over axes (u, v) = (0, 1), (0, 2), (1, 2)
    const float xu = t == 2 ? xp[1] : xp[0], xv = t == 0 ? xp[1] : xp[2];
    const float* de = d_embed + nc;
    float du = 0.f, dv = 0.f;
    scale_plane_dx<Sh::R0>(P.s[0], t, xu, xv, de, S, du, dv);
    scale_plane_dx<Sh::R1>(P.s[1], t, xu, xv, de + FEAT * S, S, du, dv);
    if constexpr (Sh::NS > 2)
      scale_plane_dx<Sh::R2>(P.s[2], t, xu, xv, de + 2 * FEAT * S, S, du,
                             dv);
    dx[0] = t < 2 ? du : 0.f;
    dx[1] = t == 0 ? dv : t == 2 ? du : 0.f;
    dx[2] = t >= 1 ? dv : 0.f;
  }

  const Tap tp[3] = {make_tap<RCP>(xp[0]), make_tap<RCP>(xp[1]),
                     make_tap<RCP>(xp[2])};
  float dcp[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < (Sh::NCPG + 3) / 4; ++i) {
    const int c = 4 * (t + 4 * i);           // channel group t + 4 i
    if (c >= CCP) continue;
    float4 f[3], df[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* L = P.cp + (size_t)a * RCP * CCP + c;
      const float4 lo = ld4(L + tp[a].i0 * CCP);
      const float4 hi = ld4(L + tp[a].i1 * CCP);
      f[a] = lerp4(lo, hi, tp[a].w);
      df[a] = sub4(tp[a].has_next ? hi : make_float4(0.f, 0.f, 0.f, 0.f), lo);
    }
    const float* de = d_embed + (size_t)(Sh::NS * FEAT + c) * S + nc;
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

// ---------------------------------------------------------- launches ----

// blocks: the plan's blocks per role (ops/_build.FieldShape.encode_plan);
// a role gets no more blocks than it has tiles.
template <class Sh>
int encode_forward(const float* x, Planes P, int n, float* out,
                   const int blocks[K0_ROLES], cudaStream_t st) {
  if (n <= 0) return (int)cudaSuccess;
  if ((long long)n * Sh::NCPG >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  K0Plan plan;
  int grid = 0;
  for (int r = 0; r < K0_ROLES; ++r) {
    const long long items = r == K0_ROLES - 1 ? (long long)n * Sh::NCPG
                            : r < Sh::NS      ? n
                                              : 0;
    const long long tiles = (items + K0_THREADS - 1) / K0_THREADS;
    plan.blocks[r] = (int)(blocks[r] < tiles ? blocks[r] : tiles);
    if (items > 0 && plan.blocks[r] < 1) return (int)cudaErrorInvalidValue;
    grid += plan.blocks[r];
  }
  encode_fwd_kernel<Sh><<<grid, K0_THREADS, k0_smem_bytes<Sh>(), st>>>(
      x, P, n, out, plan);
  return (int)cudaGetLastError();
}

// Once per device before the first launch: K0's dynamic shared memory
// exceeds the default 48 KB.
template <class Sh>
int encode_setup() {
  return (int)cudaFuncSetAttribute(encode_fwd_kernel<Sh>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   k0_smem_bytes<Sh>());
}

// acc: Sh::PLANES + Sh::CP_SIZE zeroed int64 accumulators, mx: 3 zeroed
// unsigned ints; d_s2 is not written with 2 scales.
template <class Sh>
int plane_backward(const float* x, const float* d_embed, const float* cp,
                   int n, float* d_s0, float* d_s1, float* d_s2, float* d_cp,
                   void* acc, void* mx, cudaStream_t st) {
  unsigned long long* a = (unsigned long long*)acc;
  unsigned* m = (unsigned*)mx;
  if (n > 0) {
    const int mblocks = (n + K3_MAX_THREADS - 1) / K3_MAX_THREADS;
    const dim3 mgrid(mblocks < 64 ? mblocks : 64, Sh::EMB);
    k3_absmax_kernel<Sh><<<mgrid, K3_MAX_THREADS, 0, st>>>(d_embed, cp, n, m);
    const int grid = ((n + 31) / 32 + K3_WARPS - 1) / K3_WARPS;
    plane_bwd_kernel<Sh><<<grid, K3_THREADS, 0, st>>>(x, d_embed, cp, n, m,
                                                      a);
  }
  constexpr int total = Sh::PLANES + Sh::CP_SIZE;
  k3_finish_kernel<Sh><<<(total + K3_MAX_THREADS - 1) / K3_MAX_THREADS,
                         K3_MAX_THREADS, 0, st>>>(a, m, n > 0 ? n : 1, d_s0,
                                                  d_s1, d_s2, d_cp);
  return (int)cudaGetLastError();
}

// d_x_pe: null, or [3, N] added to the result.
template <class Sh>
int x_backward(const float* x, const float* d_embed, Planes P, int n,
               const float* d_x_pe, float* d_x, cudaStream_t st) {
  if (n <= 0) return (int)cudaSuccess;
  const int grid = (int)(((size_t)n * 4 + K4_THREADS - 1) / K4_THREADS);
  x_bwd_kernel<Sh><<<grid, K4_THREADS, 0, st>>>(x, d_embed, P, n, d_x_pe,
                                                d_x);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mf

// The C entry points of K0, K3 and K4 at shape SH, each named
// <name>_SUFFIX. Plane pointers are s0, s1, s2 (s2 null with 2 scales),
// then cp.
#define MF_TRIPLANE_ENTRY_POINTS(SH, SUFFIX)                                  \
  extern "C" int mf_encode_forward_##SUFFIX(                                 \
      const float* x, const float* s0, const float* s1, const float* s2,     \
      const float* cp, int n, float* out, int b0, int b1, int b2, int bcp,   \
      void* stream) {                                                        \
    const int blocks[mf::K0_ROLES] = {b0, b1, b2, bcp};                      \
    return mf::encode_forward<SH>(x, mf::Planes{{s0, s1, s2}, cp}, n, out,   \
                                  blocks, (cudaStream_t)stream);             \
  }                                                                          \
  extern "C" int mf_encode_setup_##SUFFIX() {                                \
    return mf::encode_setup<SH>();                                           \
  }                                                                          \
  extern "C" int mf_encode_smem_size_##SUFFIX() {                            \
    return mf::k0_smem_bytes<SH>();                                          \
  }                                                                          \
  extern "C" int mf_plane_backward_acc_size_##SUFFIX() {                     \
    return SH::PLANES + SH::CP_SIZE;                                         \
  }                                                                          \
  extern "C" int mf_plane_backward_##SUFFIX(                                 \
      const float* x, const float* d_embed, const float* cp, int n,          \
      float* d_s0, float* d_s1, float* d_s2, float* d_cp, void* acc,         \
      void* mx, void* stream) {                                              \
    return mf::plane_backward<SH>(x, d_embed, cp, n, d_s0, d_s1, d_s2, d_cp, \
                                  acc, mx, (cudaStream_t)stream);            \
  }                                                                          \
  extern "C" int mf_x_backward_##SUFFIX(                                     \
      const float* x, const float* d_embed, const float* s0,                 \
      const float* s1, const float* s2, const float* cp, int n,              \
      const float* d_x_pe, float* d_x, void* stream) {                       \
    return mf::x_backward<SH>(x, d_embed, mf::Planes{{s0, s1, s2}, cp}, n,   \
                              d_x_pe, d_x, (cudaStream_t)stream);            \
  }
