// K2: decoder backward, a template over the field shape (common.cuh
// FieldShape), instantiated once per shape by shape.cu. (K1, the fused
// field forward whose saved embed K2 reads, is in field_forward.cuh; the
// 3xTF32 split both use is in tf32.cuh.)
//
// K2 replaces mipsfusion_tpu/ops/field_pallas.py _decoder_bwd_call
// (_make_decoder_bwd_kernel). A point needs ~115k MACs (forward recompute
// 38k, data backward 38k, weight gradients 39k; at the flagship's E = 48)
// against ~0.45 KB of I/O,
// so on this card it is bound by arithmetic. Every decoder product runs on the tensor cores as
// mma.sync.m16n8k8 TF32 with the 3xTF32 split (a = hi + lo, a b ~ a_lo b_hi
// + a_hi b_lo + a_hi b_hi, float32 accumulation), which keeps float32
// accuracy; single TF32 (~3 digits) would not hold the 1e-4 tolerance.
// Widths are padded to multiples of 8 (PE 51 -> 56, rgb input 115 -> 120,
// the embed E 44 -> 48 and 52 -> 56 with zero rows, as the TPU kernel's
// _round8). One persistent block per SM (512 threads, a tile of 64 points
// x 456 + E_pad rows: 145 KB at the flagship, 147 KB at E 52) walks the
// point tiles: forward recompute from x and the saved
// embed, softmax-head backward, then the backward sweep, overwriting each
// activation with its gradient in place. The weight gradients dW = sum_n
// a_n d_n^T are taken per tile on the tensor cores as soon as a layer's
// gradient exists and added into the block's own partial (plain read-add-
// write of a [38625] slice at the flagship in device memory that only this
// block touches);
// a fixed-order sum of the per-block partials follows, so the result is
// deterministic. No per-point workspace goes through device memory. The
// PE chain of d_x, the softmax head and the bias sums stay on the CUDA
// cores in float32. Weight gradients come back in the plain parameter
// layout ([in, out] then the bias row), with the real E: padded rows
// never reach them.

#pragma once
#include "common.cuh"
#include "tf32.cuh"

namespace mf {
namespace {                                  // one copy per shape's object

// Point coordinate d of tile column p (padding columns read 0.5).
__device__ __forceinline__ float tile_x(const float* __restrict__ x, int N,
                                        int n0, int nv, int d, int p) {
  return p < nv ? x[(size_t)d * N + n0 + p] : 0.5f;
}

// PE rows [51][BP] of a tile, as (row, point) work items over all threads.
template <int BP, int NT, int LD = BP>
__device__ __forceinline__ void tile_pe(const float* __restrict__ x, int N,
                                        int n0, int nv, float* pe) {
  for (int it = threadIdx.x; it < (3 + 3 * NFREQ) * BP; it += NT) {
    const int r = it / BP, p = it % BP;
    if (r < 3) {
      pe[r * LD + p] = tile_x(x, N, n0, nv, r, p);
    } else {
      const int d = (r - 3) / NFREQ, j = (r - 3) % NFREQ;
      float sn, cs;
      sincosf(tile_x(x, N, n0, nv, d, p) * pe_freq(j), &sn, &cs);
      pe[(3 + d * 2 * NFREQ + 2 * j) * LD + p] = sn;
      pe[(3 + d * 2 * NFREQ + 2 * j + 1) * LD + p] = cs;
    }
  }
}

// ---------------------------------------------------------------- K2 ----
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b for one m16n8k8 fragment, a and b split into hi + lo
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

template <int K>
__device__ __forceinline__ void split_n(const float* v, uint32_t* hi,
                                        uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < K; ++i) split_tf32(v[i], hi[i], lo[i]);
}

constexpr int K2_BP = 64;                    // points per tile
constexpr int K2_LD = K2_BP + 8;             // row stride, = 8 mod 32 banks
constexpr int K2_NT = 512;
constexpr int K2_WARPS = K2_NT / 32;
constexpr int PE_PAD = 56;

// The tile rows and the flat gradient at shape Sh (E = Sh::EMB real embed
// rows, EP = Sh::EMB_PAD tile rows).
template <class Sh>
struct K2Layout {
  static constexpr int E = Sh::EMB, EP = Sh::EMB_PAD;
  // tile rows [row][K2_LD], one column per point; the sdf-branch input
  // (rows 0..63+EP) and the rgb-branch input (64+EP.. +115) are contiguous
  static constexpr int T_H1S = 0;            // h1 sdf 64  -> d h1 sdf
  static constexpr int T_EMB = NSDF;         // embed E + zero rows to EP
  static constexpr int T_H1R = NSDF + EP;    // h1 rgb 64  -> d h1 rgb
  static constexpr int T_PE = T_H1R + NRGB;  // pe 51 + 5 zero rows -> d pe
  static constexpr int T_H0 = T_PE + PE_PAD; // h0 128     -> d h0
  static constexpr int T_H2 = T_H0 + HID;    // h2 128     -> d h2
  static constexpr int T_LOG = T_H2 + HBR;   // logits 5 -> d logits (8 rows)
  static constexpr int T_G = T_LOG + 8;      // rgb cotangent 3 (8 rows)
  static constexpr int ROWS = T_G + 8;       // 504 at EP 48, 512 at 56
  static constexpr int SMEM = ROWS * K2_LD * 4;   // one block per SM
  static_assert(SMEM <= 232448, "K2 tile");
  // the sdf-branch input as rows of a weight-gradient product: 16-row
  // blocks (past 64 + E they read the next finite rows, whose products are
  // dropped)
  static constexpr int S_IN_M = (NSDF + E + 15) / 16 * 16;
  // flat gradient: per layer the [in + 1, out] block (w rows, bias row)
  static constexpr int OFF_W0 = 0;
  static constexpr int OFF_W1 = OFF_W0 + (PE + 1) * HID;
  static constexpr int OFF_WR = OFF_W1 + (HID + 1) * (NSDF + NRGB);
  static constexpr int OFF_WS0 = OFF_WR + (NRGB + PE + 1) * 3;
  static constexpr int OFF_WS1 = OFF_WS0 + (NSDF + E + 1) * HBR;
  static constexpr int GRAD_SIZE = OFF_WS1 + (HBR + 1) * NCLS;
  // transposed weight copies: Ws0^T [128][64 + E], W1^T [128][128],
  // W0^T [128][56] (PE rows padded to 56, zeros)
  static constexpr int WT_S0 = 0;
  static constexpr int WT_1 = WT_S0 + HBR * (NSDF + E);
  static constexpr int WT_0 = WT_1 + (NSDF + NRGB) * HID;
  static constexpr int WT_SIZE = WT_0 + HID * PE_PAD;
};

template <class Sh>
__global__ void transpose_weights_kernel(DecoderW dw, float* __restrict__ wt) {
  using K = K2Layout<Sh>;
  constexpr int WT_S0 = K::WT_S0, WT_1 = K::WT_1, WT_0 = K::WT_0;
  constexpr int EMB = Sh::EMB;
  static_assert(HBR * (NSDF + EMB) <= HID * HID, "one grid covers Ws0");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < HBR * (NSDF + EMB)) {              // Ws0 [64+E][128] -> [128][64+E]
    const int j = i / (NSDF + EMB), k = i % (NSDF + EMB);
    wt[WT_S0 + i] = dw.ws0[k * HBR + j];
  }
  if (i < (NSDF + NRGB) * HID) {             // W1 [128][128] -> [128][128]
    const int j = i / HID, k = i % HID;
    wt[WT_1 + i] = dw.w1[k * (NSDF + NRGB) + j];
  }
  if (i < HID * PE_PAD) {                    // W0 [51][128] -> [128][56]
    const int j = i / PE_PAD, k = i % PE_PAD;
    wt[WT_0 + i] = k < PE ? dw.w0[k * HID + j] : 0.f;
  }
}

// Row i of a logical matrix -> tile row (two contiguous pieces).
struct RowMap {
  int base0, split, base1;
  __device__ __forceinline__ int operator()(int i) const {
    return i < split ? base0 + i : base1 + (i - split);
  }
};
__device__ __forceinline__ RowMap rows_at(int base) {
  return RowMap{base, 1 << 30, 0};
}
template <class Sh>
__device__ __forceinline__ RowMap h1_rows() {   // h1 / d h1: sdf | rgb
  return RowMap{K2Layout<Sh>::T_H1S, NSDF, K2Layout<Sh>::T_H1R};
}

// out[p][n] = sum_k A[k][p] B[k][n] for the tile's 64 points, on the tensor
// cores (3xTF32). A: K tile rows through `am` (k < Kv used; rows Kv..K-1
// must hold finite values). B[k][n] = W[k * ldk + n * ldn] for k < Kv and
// n < Nv, else 0. A warp job is one 8-column tile x MT 16-point tiles, so
// each B fragment serves MT products; epi(p, n, value) for n < N.
template <int K, int N, int MT, class Epi>
__device__ __forceinline__ void prod_points(const float* T, RowMap am,
                                            const float* __restrict__ W,
                                            int ldk, int ldn, int Kv, int Nv,
                                            Epi epi) {
  constexpr int NTILE = N / 8, MG = K2_BP / 16 / MT, JOBS = NTILE * MG;
  static_assert(N % 8 == 0 && K % 8 == 0 && (K2_BP / 16) % MT == 0, "tile");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  for (int job = warp; job < JOBS; job += K2_WARPS) {
    const int n0 = (job / MG) * 8, m0 = (job % MG) * MT * 16;
    float c[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
    const int nb = n0 + g;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int k_lo = k0 + t, k_hi = k0 + t + 4;
      const float b[2] = {
          (k_lo < Kv && nb < Nv) ? __ldg(W + k_lo * ldk + nb * ldn) : 0.f,
          (k_hi < Kv && nb < Nv) ? __ldg(W + k_hi * ldk + nb * ldn) : 0.f};
      uint32_t bh[2], bl[2];
      split_n<2>(b, bh, bl);
      const float* r0 = T + am(k_lo) * K2_LD + m0 + g;
      const float* r1 = T + am(k_hi) * K2_LD + m0 + g;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float a[4] = {r0[i * 16], r0[i * 16 + 8], r1[i * 16],
                            r1[i * 16 + 8]};
        uint32_t ah[4], al[4];
        split_n<4>(a, ah, al);
        mma3(c[i], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int p = m0 + i * 16 + g, n = n0 + 2 * t;
      epi(p, n, c[i][0]);
      epi(p, n + 1, c[i][1]);
      epi(p + 8, n, c[i][2]);
      epi(p + 8, n + 1, c[i][3]);
    }
  }
}

// dW[m][n] += sum_p A[m][p] D[n][p] over the tile's 64 points (3xTF32):
// A is M tile rows through `am`, D is N tile rows through `dm`; only
// m < Mv, n < Nv are kept (other rows only feed discarded outputs). The
// block's own partial gradient `part` ([Mv][Nv] rows) is read, added to
// and written back: no other block touches it, so no atomics.
template <int M, int N>
__device__ __forceinline__ void prod_wgrad(const float* T, RowMap am, int Mv,
                                           RowMap dm, int Nv, float* part) {
  constexpr int NW = (N / 8) < 4 ? (N / 8) : 4;      // n tiles per job
  constexpr int NG = N / 8 / NW, JOBS = (M / 16) * NG;
  static_assert(M % 16 == 0 && N % 8 == 0 && (N / 8) % NW == 0, "tile");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  for (int job = warp; job < JOBS; job += K2_WARPS) {
    const int m0 = (job / NG) * 16, n0 = (job % NG) * NW * 8;
    float c[NW][4];
#pragma unroll
    for (int i = 0; i < NW; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
    const float* a0 = T + am(m0 + g) * K2_LD + t;
    const float* a1 = T + am(m0 + g + 8) * K2_LD + t;
    const float* d[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) d[i] = T + dm(n0 + i * 8 + g) * K2_LD + t;
#pragma unroll 2
    for (int k0 = 0; k0 < K2_BP; k0 += 8) {
      const float a[4] = {a0[k0], a1[k0], a0[k0 + 4], a1[k0 + 4]};
      uint32_t ah[4], al[4];
      split_n<4>(a, ah, al);
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const float b[2] = {d[i][k0], d[i][k0 + 4]};
        uint32_t bh[2], bl[2];
        split_n<2>(b, bh, bl);
        mma3(c[i], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int n = n0 + i * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + g + 8 * h;
        if (m >= Mv) continue;
        if (n < Nv) part[m * Nv + n] += c[i][2 * h];
        if (n + 1 < Nv) part[m * Nv + n + 1] += c[i][2 * h + 1];
      }
    }
  }
}

// bias gradient: dst[j] += sum over the tile's points of D[j] (j < Nv)
__device__ __forceinline__ void bias_sum(const float* T, RowMap dm, int Nv,
                                         float* dst) {
  for (int j = threadIdx.x; j < Nv; j += K2_NT) {
    const float* r = T + dm(j) * K2_LD;
    float s = 0.f;
#pragma unroll 8
    for (int p = 0; p < K2_BP; ++p) s += r[p];
    dst[j] += s;
  }
}

// The weight gradients of one backward phase from the tile's rows:
// 0 sdf1 and rgb (and their biases), 1 sdf0, 2 trunk1, 3 trunk0.
template <class Sh, int PH>
__device__ __forceinline__ void wgrad_phase(const float* T, float* part) {
  using K = K2Layout<Sh>;
  constexpr int EMB = Sh::EMB;
  constexpr int T_H1R = K::T_H1R, T_PE = K::T_PE, T_H0 = K::T_H0,
                T_H2 = K::T_H2, T_LOG = K::T_LOG, T_G = K::T_G,
                T_H1S = K::T_H1S;
  constexpr int OFF_W0 = K::OFF_W0, OFF_W1 = K::OFF_W1, OFF_WR = K::OFF_WR,
                OFF_WS0 = K::OFF_WS0, OFF_WS1 = K::OFF_WS1;
  if (PH == 0) {
    prod_wgrad<HBR, 8>(T, rows_at(T_H2), HBR, rows_at(T_LOG), NCLS,
                       part + OFF_WS1);
    prod_wgrad<128, 8>(T, rows_at(T_H1R), NRGB + PE, rows_at(T_G), 3,
                       part + OFF_WR);
    bias_sum(T, rows_at(T_LOG), NCLS, part + OFF_WS1 + HBR * NCLS);
    bias_sum(T, rows_at(T_G), 3, part + OFF_WR + (NRGB + PE) * 3);
  } else if (PH == 1) {
    prod_wgrad<K::S_IN_M, HBR>(T, rows_at(T_H1S), NSDF + EMB,
                               rows_at(T_H2), HBR, part + OFF_WS0);
    bias_sum(T, rows_at(T_H2), HBR, part + OFF_WS0 + (NSDF + EMB) * HBR);
  } else if (PH == 2) {
    prod_wgrad<HID, NSDF + NRGB>(T, rows_at(T_H0), HID, h1_rows<Sh>(),
                                 NSDF + NRGB, part + OFF_W1);
    bias_sum(T, h1_rows<Sh>(), NSDF + NRGB,
             part + OFF_W1 + HID * (NSDF + NRGB));
  } else {
    prod_wgrad<64, HID>(T, rows_at(T_PE), PE, rows_at(T_H0), HID,
                        part + OFF_W0);
    bias_sum(T, rows_at(T_H0), HID, part + OFF_W0 + PE * HID);
  }
}

// The tile's weight-gradient phase PH, when weight gradients are asked
// for (the barrier orders it before the products that overwrite its rows).
template <class Sh, bool WG, int PH>
__device__ __forceinline__ void wgrad_step(const float* T, float* part) {
  if (WG) {
    wgrad_phase<Sh, PH>(T, part);
    __syncthreads();
  }
}

// K2 per-point pass. A persistent block (one per SM, 145-147 KB of tile) walks
// 64-point tiles: forward recompute from x and the saved embed, then the
// backward sweep, every decoder product on the tensor cores (3xTF32),
// each activation overwritten in place by its gradient once the products
// that read it are done. WG adds, right after each layer's gradients
// exist, that layer's dW over the tile into the block's partial
// ([gridDim.x, GRAD_SIZE], zeroed by the caller, summed by
// sum_partials_kernel); without WG (GO: pose gradients only) it computes
// d_x and d_embed alone.
template <class Sh, bool WG>
__global__ void __launch_bounds__(K2_NT, 1)
    decoder_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ embed, int N, DecoderW dw,
                       const float* __restrict__ wt,
                       float* __restrict__ partials,
                       float* __restrict__ d_x, float* __restrict__ d_embed) {
  using K = K2Layout<Sh>;
  constexpr int EMB = Sh::EMB, EP = Sh::EMB_PAD;
  constexpr int T_H1S = K::T_H1S, T_EMB = K::T_EMB, T_H1R = K::T_H1R,
                T_PE = K::T_PE, T_H0 = K::T_H0, T_H2 = K::T_H2,
                T_LOG = K::T_LOG, T_G = K::T_G;
  constexpr int WT_S0 = K::WT_S0, WT_1 = K::WT_1, WT_0 = K::WT_0;
  extern __shared__ float4 sm4[];
  float* T = reinterpret_cast<float*>(sm4);
  constexpr int BP = K2_BP, NT = K2_NT, LD = K2_LD;
  const size_t S = N;
  const int n_tiles = (N + BP - 1) / BP;
  float* part = partials + (size_t)blockIdx.x * K::GRAD_SIZE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = tile * BP, nv = min(BP, N - n0);
    // ---- inputs: embed (+ zero pad rows), PE (+ zero pad rows), the rgb
    // cotangent ----
    for (int it = threadIdx.x; it < EP * BP; it += NT) {
      const int e = it / BP, p = it % BP;
      T[(T_EMB + e) * LD + p] =
          (e < EMB && p < nv) ? embed[e * S + n0 + p] : 0.f;
    }
    tile_pe<BP, NT, LD>(x, N, n0, nv, T + T_PE * LD);
    // rows PE..55 of pe and the 8 logit rows zero, the 8 g rows g_rgb
    constexpr int PAD = PE_PAD - PE;
    for (int it = threadIdx.x; it < (PAD + 16) * BP; it += NT) {
      const int r = it / BP, p = it % BP;
      if (r < PAD) {
        T[(T_PE + PE + r) * LD + p] = 0.f;
      } else if (r < PAD + 8) {
        T[(T_LOG + r - PAD) * LD + p] = 0.f;
      } else {
        const int c = r - PAD - 8;
        T[(T_G + c) * LD + p] = (c < 3 && p < nv) ? g[c * S + n0 + p] : 0.f;
      }
    }
    __syncthreads();
    // ---- forward recompute ----
    prod_points<PE_PAD, HID, 4>(
        T, rows_at(T_PE), dw.w0, HID, 1, PE, HID, [&](int p, int n, float v) {
          T[(T_H0 + n) * LD + p] = fmaxf(v + __ldg(dw.b0 + n), 0.f);
        });
    __syncthreads();
    prod_points<HID, NSDF + NRGB, 4>(
        T, rows_at(T_H0), dw.w1, NSDF + NRGB, 1, HID, NSDF + NRGB,
        [&](int p, int n, float v) {
          T[h1_rows<Sh>()(n) * LD + p] = v + __ldg(dw.b1 + n);
        });
    __syncthreads();
    prod_points<NSDF + EP, HBR, 4>(
        T, rows_at(T_H1S), dw.ws0, HBR, 1, NSDF + EMB, HBR,
        [&](int p, int n, float v) {
          T[(T_H2 + n) * LD + p] = fmaxf(v + __ldg(dw.bs0 + n), 0.f);
        });
    __syncthreads();
    prod_points<HBR, 8, 1>(
        T, rows_at(T_H2), dw.ws1, NCLS, 1, HBR, NCLS,
        [&](int p, int n, float v) {
          if (n < NCLS) T[(T_LOG + n) * LD + p] = v + __ldg(dw.bs1 + n);
        });
    __syncthreads();
    // ---- softmax-head backward, one thread per point: d logits ----
    if (threadIdx.x < BP) {
      const int p = threadIdx.x;
      const bool ok = p < nv;
      float logits[NCLS], prob[NCLS], gp[NCLS], dot = 0.f;
#pragma unroll
      for (int c = 0; c < NCLS; ++c) logits[c] = T[(T_LOG + c) * LD + p];
      softmax_head(logits, prob);
      const float g_sdf = ok ? g[3 * S + n0 + p] : 0.f;
      const float g_ent = ok ? g[4 * S + n0 + p] : 0.f;
      const float ln2 = 0.69314718055994530942f, eps = 1e-5f;
#pragma unroll
      for (int c = 0; c < NCLS; ++c) {
        const float pc = prob[c];
        const float dent = -(log2f(pc + eps) + pc / ((pc + eps) * ln2));
        gp[c] = (ok ? g[(size_t)(5 + c) * S + n0 + p] : 0.f) +
                g_sdf * (2.0f / (float)(NCLS - 1)) * (float)c + g_ent * dent;
        dot += gp[c] * pc;
      }
#pragma unroll
      for (int c = 0; c < NCLS; ++c)
        T[(T_LOG + c) * LD + p] = prob[c] * (gp[c] - dot);
    }
    __syncthreads();
    wgrad_step<Sh, WG, 0>(T, part);     // sdf1, rgb
    // d h2 = (Ws1 d logits) * (h2 > 0), in place of h2
    prod_points<8, HBR, 4>(
        T, rows_at(T_LOG), dw.ws1, 1, NCLS, NCLS, HBR,
        [&](int p, int n, float v) {
          float* o = T + (T_H2 + n) * LD + p;
          *o = *o > 0.f ? v : 0.f;
        });
    // d h1_rgb = Wr[:64] g_rgb, in place of h1_rgb
    prod_points<8, NRGB, 4>(
        T, rows_at(T_G), dw.wr, 1, 3, 3, NRGB,
        [&](int p, int n, float v) { T[(T_H1R + n) * LD + p] = v; });
    __syncthreads();
    wgrad_step<Sh, WG, 1>(T, part);     // sdf0
    // d sdf_in = Ws0 d h2 -> d h1_sdf (rows 0..63), d embed (rows 64..63+E;
    // the pad rows to 64+EP get 0)
    prod_points<HBR, NSDF + EP, 4>(
        T, rows_at(T_H2), wt + WT_S0, NSDF + EMB, 1, HBR, NSDF + EMB,
        [&](int p, int n, float v) { T[(T_H1S + n) * LD + p] = v; });
    __syncthreads();
    for (int it = threadIdx.x; it < EMB * BP; it += NT) {
      const int e = it / BP, p = it % BP;
      if (p < nv) d_embed[e * S + n0 + p] = T[(T_EMB + e) * LD + p];
    }
    wgrad_step<Sh, WG, 2>(T, part);     // trunk1
    // d h0 = (W1 d h1) * (h0 > 0), in place of h0
    prod_points<NSDF + NRGB, HID, 4>(
        T, h1_rows<Sh>(), wt + WT_1, HID, 1, NSDF + NRGB, HID,
        [&](int p, int n, float v) {
          float* o = T + (T_H0 + n) * LD + p;
          *o = *o > 0.f ? v : 0.f;
        });
    __syncthreads();
    wgrad_step<Sh, WG, 3>(T, part);     // trunk0
    // d pe = W0 d h0 + Wr[64:] g_rgb, in place of pe (rows < 51)
    prod_points<HID, PE_PAD, 2>(
        T, rows_at(T_H0), wt + WT_0, PE_PAD, 1, HID, PE,
        [&](int p, int n, float v) {
          if (n >= PE) return;
          const float* wr = dw.wr + (NRGB + n) * 3;
          v += __ldg(wr) * T[T_G * LD + p] +
               __ldg(wr + 1) * T[(T_G + 1) * LD + p] +
               __ldg(wr + 2) * T[(T_G + 2) * LD + p];
          T[(T_PE + n) * LD + p] = v;
        });
    __syncthreads();
    // d x through the PE: raw-x rows plus the sin/cos chain, on CUDA cores
    for (int it = threadIdx.x; it < 3 * BP; it += NT) {
      const int d = it / BP, p = it % BP;
      if (p >= nv) continue;
      const float* dpe = T + T_PE * LD + p;
      const float xd = x[d * S + n0 + p];
      float acc = dpe[d * LD];
#pragma unroll
      for (int j = 0; j < NFREQ; ++j) {
        const float f = pe_freq(j);
        float sn, cs;
        sincosf(xd * f, &sn, &cs);
        acc += (dpe[(3 + d * 2 * NFREQ + 2 * j) * LD] * cs -
                dpe[(3 + d * 2 * NFREQ + 2 * j + 1) * LD] * sn) * f;
      }
      d_x[d * S + n0 + p] = acc;
    }
    __syncthreads();                         // the next tile rewrites T
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    int splits, int total,
                                    float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partials[(size_t)k * total + i];
  out[i] = s;
}

// ---------------------------------------------------------- launches ----

template <class Kern>
cudaError_t set_smem(Kern kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// grads: flat [GRAD_SIZE] = per layer (trunk0, trunk1, rgb, sdf0, sdf1) the
// [in+1, out] block of w rows followed by the bias row. partials:
// [splits, GRAD_SIZE] zeros, one per block of the persistent grid (splits
// blocks, one per SM). With weight_grads = 0 only d_x and d_embed are
// computed (partials and grads are not touched).
template <class Sh>
int decoder_backward(const float* x, const float* g, const float* embed,
                     int n, DecoderW dw, float* wt, float* partials,
                     int splits, float* d_x, float* d_embed, float* grads,
                     int weight_grads, cudaStream_t st) {
  using K = K2Layout<Sh>;
  if (n <= 0) return (int)cudaSuccess;
  static bool attr_set[MAX_DEVICES] = {};
  cudaError_t e = once_per_device(attr_set, [] {
    cudaError_t r = set_smem(decoder_bwd_kernel<Sh, false>, K::SMEM);
    return r != cudaSuccess ? r
                            : set_smem(decoder_bwd_kernel<Sh, true>, K::SMEM);
  });
  if (e != cudaSuccess) return (int)e;
  transpose_weights_kernel<Sh><<<(HID * HID + 255) / 256, 256, 0, st>>>(dw,
                                                                        wt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int n_tiles = (n + K2_BP - 1) / K2_BP;
  const int grid = n_tiles < splits ? n_tiles : splits;
  if (!weight_grads) {
    decoder_bwd_kernel<Sh, false><<<grid, K2_NT, K::SMEM, st>>>(
        x, g, embed, n, dw, wt, partials, d_x, d_embed);
    return (int)cudaGetLastError();
  }
  decoder_bwd_kernel<Sh, true><<<grid, K2_NT, K::SMEM, st>>>(
      x, g, embed, n, dw, wt, partials, d_x, d_embed);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_partials_kernel<<<(K::GRAD_SIZE + 255) / 256, 256, 0, st>>>(
      partials, splits, K::GRAD_SIZE, grads);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mf

// The C entry points of K2 at shape SH, each named <name>_SUFFIX.
#define MF_DECODER_BACKWARD_ENTRY_POINTS(SH, SUFFIX)                          \
  extern "C" int mf_decoder_wt_size_##SUFFIX() {                             \
    return mf::K2Layout<SH>::WT_SIZE;                                        \
  }                                                                          \
  extern "C" int mf_decoder_grad_size_##SUFFIX() {                           \
    return mf::K2Layout<SH>::GRAD_SIZE;                                      \
  }                                                                          \
  extern "C" int mf_decoder_backward_##SUFFIX(                               \
      const float* x, const float* g, const float* embed, int n,             \
      MF_DECODER_ARGS, float* wt, float* partials, int splits, float* d_x,   \
      float* d_embed, float* grads, int weight_grads, void* stream) {        \
    return mf::decoder_backward<SH>(                                         \
        x, g, embed, n,                                                      \
        mf::make_dw(w0, b0, w1, b1, wr, br, ws0, bs0, ws1, bs1), wt,         \
        partials, splits, d_x, d_embed, grads, weight_grads,                 \
        (cudaStream_t)stream);                                               \
  }
