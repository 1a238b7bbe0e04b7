// K2: decoder backward, a template over the field shape (common.cuh
// FieldShape), instantiated once per shape by shape.cu. (K1, the fused
// field forward whose saved embed K2 reads, is in field_forward.cuh; the
// 3xTF32 split both use is in tf32.cuh.)
//
// K2 replaces mipsfusion_tpu/ops/field_pallas.py _decoder_bwd_call
// (_make_decoder_bwd_kernel): from x, the output cotangent g and the saved
// embed it returns d_x through the PE, d_embed and, with weight gradients,
// every decoder parameter's gradient.
//
// What bounds it on this card: a point needs ~118k MACs (forward recompute
// 39k, data backward 39k, weight gradients 40k at the flagship's E = 48)
// against ~0.45 KB of I/O, so it is bound by arithmetic: every product of
// the wide layers runs on the tensor cores as mma.sync.m16n8k8 TF32 with
// the 3xTF32 split (a = hi + lo, three products; float32 accuracy, which
// single TF32 would not hold), at best about one product every 2 cycles
// an SM. The operands are the cost around it: the weights of both
// directions (81k floats, 162k split) do not fit in shared memory beside a
// tile and the running weight gradient (39k floats), so they come from L2;
// every activation a warp reads as an operand must be split into hi and lo
// (three instructions a value); and the weight gradient must stay on chip
// until the block's last tile.
//
// Design. One persistent block of 8 warps per SM walks 64-point tiles.
//  * The tile: every activation and gradient of its points as rows of 64
//    floats in shared memory, one column per point, each row's columns
//    XOR-swizzled so that the fragment accesses below are 8 bytes wide and
//    free of bank conflicts. A ones row follows PE and h2, so the last
//    column of trunk0's, rgb's and sdf1's weight gradient is the bias
//    gradient; sdf0's and trunk1's bias sums take the CUDA cores (a row a
//    thread) beside their products. The next tile's x and g arrive by
//    cp.async while this tile's backward runs, its PE is made into a
//    second PE block two phases before this tile's is last read, and its
//    embed arrives in the last two phases (16 bytes a copy where the rows
//    are aligned).
//  * Per-point products (forward recompute, data backward): a layer's
//    output columns are split over the warps; a job is 4 column tiles of
//    2 m-tiles on the 128-wide layers (2 x 2 on d sdf_in and d pe). The
//    weights come packed in fragment order and split once into hi and lo
//    by k2_pack_weights_kernel: a B fragment is two 16-byte loads,
//    prefetched a k-block ahead, serving 6 products; an A fragment is two
//    8-byte loads, split once for 12. The single-k-block products (d h2
//    from the logits' gradient, d h1 rgb from g_rgb) load their B
//    fragments ahead of the phase's other work.
//  * Weight gradients dW = sum_p a_p d_p^T take the points as the
//    reduction axis: warp w owns output features 32 (w % 4) .. + 31 (two
//    m-tiles) of every wide layer and half of its input's column tiles,
//    and accumulates their dW^T fragments over every tile the block
//    walks: trunk1 (8 + 8 column tiles) and sdf0 (7 + 7, 8 + 7 at E 52) in
//    registers, trunk0 (4 + 3) in a per-warp region of shared memory. An
//    X fragment serves both m-tiles. The narrow layers (sdf1's 5 classes,
//    rgb's 3) take the CUDA cores instead, in float32: one input row a
//    thread, its running sums in shared memory. The block writes its
//    partial to device memory once, at the end; a fixed-order sum of the
//    partials follows, so a call gives the same bits every time. No float
//    atomics.
//  * Phases that can run together share one barrier: a layer's weight
//    gradient beside the next data-backward product, whose output goes to
//    rows nobody reads in that phase (d h2 and d h0 to rows of their own);
//    9 barriers a tile. The logits of an m-tile are summed by a pair of
//    warps (half the k-blocks each, swapped through shared memory under a
//    named barrier), and each runs the softmax head's backward on its
//    quads for one of a thread's two points. PE and d x through the PE
//    (from the tile's own sin and cos rows) are spread over the block.
// Resources (nvcc -Xptxas -v, sm_90a): 255 registers a thread in both
// instances (the one with weight gradients spills 4 bytes); shared memory
// 223,232 bytes a block at E 44 and 48, 225,280 at E 52: 178-180 KB of
// tile rows (two PE blocks included), 32 KB of trunk0's dW, 8 KB of the
// CUDA cores' sums.
// Precision: float32 storage; 3xTF32 products with float32 accumulation on
// the tensor cores, float32 sums on the CUDA cores. Weight gradients come
// back in the plain parameter layout ([in, out] then the bias row), with
// the real E: padded rows never reach them.

#pragma once
#include "common.cuh"
#include "field_forward.cuh"
#include "tf32.cuh"

namespace mf {
namespace {                                  // one copy per shape's object

constexpr int K2_P = 64;                     // points per tile
constexpr int K2_NT = 256;                   // 8 warps a block
constexpr int K2_WARPS = K2_NT / 32;
constexpr int K2_LD = K2_P;                  // floats per tile row
constexpr int K2_KB = K2_P / 8;              // k-blocks of a weight gradient
constexpr int K2_SLOTS = 8;                  // shared-memory dW tiles a warp
constexpr int K2_PF = 32 * 8;                // packed floats a k-block and pair
constexpr int PE_ROWS = 56;                  // PE 51, the ones row, zeros
constexpr int H2_ROWS = 136;                 // h2 128, the ones row, zeros
static_assert(HID == 128 && HBR == 128 && NSDF == 64 && NRGB == 64,
              "flagship widths");

// The tile rows, the packed weights and the flat gradient at shape Sh.
template <class Sh>
struct K2Layout {
  static constexpr int E = Sh::EMB;
  static constexpr int EF = (E + 7) / 8 * 8;         // embed rows, zero-padded
  static constexpr int NIN_S0 = NSDF + E;            // sdf0 inputs
  // tile rows; [h1 sdf | embed] (sdf0's input) is contiguous, and so is
  // [h1 rgb | PE | 1] (rgb's) on the tiles that take the first PE block
  static constexpr int R_H1S = 0;
  static constexpr int R_EMB = R_H1S + NSDF;
  static constexpr int R_H1R = R_EMB + EF;
  static constexpr int R_PE = R_H1R + NRGB;
  static constexpr int R_H0 = R_PE + PE_ROWS;        // h0; later d pe
  static constexpr int R_H2 = R_H0 + HID;            // h2; later d sdf_in
  static constexpr int R_LOG = R_H2 + H2_ROWS;       // d logits (8 rows)
  static constexpr int R_G = R_LOG + 8;              // rgb cotangent (8 rows)
  static constexpr int R_DH2 = R_G + 8;              // d h2; later d h0
  static constexpr int R_XN = R_DH2 + HBR;           // fetched x 3, g 10
  static constexpr int R_PE2 = R_XN + 16;            // PE, alternate tiles
  static constexpr int ROWS = R_PE2 + PE_ROWS;
  static constexpr int SMEM =
      (ROWS * K2_LD + K2_WARPS * K2_SLOTS * 128 + K2_NT * 8) * 4;
  static_assert(SMEM <= 232448, "K2 tile");
  // weight-gradient column tiles
  static constexpr int NJ_S0 = (NIN_S0 + 7) / 8;     // sdf0: 14, 14, 15
  static constexpr int NJ_1 = HID / 8;               // trunk1: 16
  static constexpr int NJ_0 = PE_ROWS / 8;           // trunk0: 7
  // packed layers, [k-block][tile pair][lane][8] floats (the hi parts of
  // the B fragments of column tiles 2p, 2p+1, then their lo parts),
  // forward then backward
  static constexpr int KB_F3 = (NSDF + EF) / 8;
  static constexpr int NT_B2 = (NIN_S0 + 7) / 8;     // d sdf_in column tiles
  static constexpr int NP_B2 = (NT_B2 + 1) / 2;
  static constexpr int P_F1 = 0;                     // W0
  static constexpr int P_F2 = P_F1 + 7 * 8 * K2_PF;    // W1
  static constexpr int P_F3 = P_F2 + 16 * 8 * K2_PF;   // Ws0
  static constexpr int P_F4 = P_F3 + KB_F3 * 8 * K2_PF;  // Ws1
  static constexpr int P_B1 = P_F4 + 16 * 1 * K2_PF;   // Ws1^T
  static constexpr int P_B2 = P_B1 + 1 * 8 * K2_PF;    // Ws0^T
  static constexpr int P_B2R = P_B2 + 16 * NP_B2 * K2_PF;  // Wr[:64]^T
  static constexpr int P_B3 = P_B2R + 1 * 4 * K2_PF;   // W1^T
  static constexpr int P_B4 = P_B3 + 16 * 8 * K2_PF;   // [W0^T; Wr[64:]^T]
  static constexpr int WT_SIZE = P_B4 + 17 * 4 * K2_PF;
  // flat gradient: per layer the [in + 1, out] block (w rows, bias row)
  static constexpr int OFF_W0 = 0;
  static constexpr int OFF_W1 = OFF_W0 + (PE + 1) * HID;
  static constexpr int OFF_WR = OFF_W1 + (HID + 1) * (NSDF + NRGB);
  static constexpr int OFF_WS0 = OFF_WR + (NRGB + PE + 1) * 3;
  static constexpr int OFF_WS1 = OFF_WS0 + (NSDF + E + 1) * HBR;
  static constexpr int GRAD_SIZE = OFF_WS1 + (HBR + 1) * NCLS;
};

// Every packed layer's B[k][n] in fragment order, split once into its
// TF32 hi and lo parts (tf32.cuh): element i of a layer with np tile pairs
// is k-block kb, pair p, lane, e (0..7); it holds the hi part (e < 4) or
// the lo part of B[k][n] with k = 8 kb + lane % 4 + 4 (e % 2), n = 8 (2p
// + e % 4 / 2) + lane / 4.
template <class Sh>
__global__ void k2_pack_weights_kernel(DecoderW dw, float* __restrict__ wt) {
  using K = K2Layout<Sh>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K::WT_SIZE) return;
  const int L = i < K::P_F2 ? 0 : i < K::P_F3 ? 1 : i < K::P_F4 ? 2
              : i < K::P_B1 ? 3 : i < K::P_B2 ? 4 : i < K::P_B2R ? 5
              : i < K::P_B3 ? 6 : i < K::P_B4 ? 7 : 8;
  constexpr int base[9] = {K::P_F1, K::P_F2, K::P_F3, K::P_F4, K::P_B1,
                           K::P_B2, K::P_B2R, K::P_B3, K::P_B4};
  constexpr int pairs[9] = {8, 8, 8, 1, 8, K::NP_B2, 4, 8, 4};
  const int r = i - base[L], np = pairs[L];
  const int e = r & 3, lane = (r >> 3) & 31, q = r >> 8;
  const int k = 8 * (q / np) + (lane & 3) + 4 * (e & 1);
  const int n = 8 * (2 * (q % np) + (e >> 1)) + (lane >> 2);
  constexpr int W1N = NSDF + NRGB;
  float v = 0.f;
  switch (L) {
    case 0: if (k < PE) v = dw.w0[k * HID + n]; break;            // W0
    case 1: v = dw.w1[k * W1N + n]; break;                          // W1
    case 2: if (k < K::NIN_S0) v = dw.ws0[k * HBR + n]; break;      // Ws0
    case 3: if (n < NCLS) v = dw.ws1[k * NCLS + n]; break;          // Ws1
    case 4: if (k < NCLS) v = dw.ws1[n * NCLS + k]; break;          // Ws1^T
    case 5: if (n < K::NIN_S0) v = dw.ws0[n * HBR + k]; break;      // Ws0^T
    case 6: if (k < 3) v = dw.wr[n * 3 + k]; break;                 // Wr^T
    case 7: v = dw.w1[n * W1N + k]; break;                          // W1^T
    default:                                  // [W0^T; Wr[64:]^T]
      if (n < PE) {
        if (k < HID) v = dw.w0[n * HID + k];
        else if (k - HID < 3) v = dw.wr[(NRGB + n) * 3 + (k - HID)];
      }
  }
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  wt[i] = __uint_as_float(r & 4 ? lo : hi);
}

// Shared-memory offset of tile row r, point column c: the column XORed
// with 8 h(r), h(r) = (r ^ r/2) mod 4. With 64-float rows this makes the
// 8-byte fragment accesses conflict-free: A of a per-point product (rows
// 8kb + t and + 4, columns 16 mi + 2g), its output (rows 8j + 2t and + 1,
// the same columns) and both operands of a weight gradient (rows base + g,
// columns 8 kb + 2t).
__device__ __forceinline__ int k2_at(int r, int c) {
  return r * K2_LD + (c ^ (((r ^ (r >> 1)) & 3) << 3));
}

__device__ __forceinline__ float2 k2_ld2(const float* T, int r, int c) {
  return *reinterpret_cast<const float2*>(T + k2_at(r, c));
}

__device__ __forceinline__ void k2_st2(float* T, int r, int c, float a,
                                       float b) {
  *reinterpret_cast<float2*>(T + k2_at(r, c)) = make_float2(a, b);
}

// c += A B, a and b split into hi + lo (the three TF32 products)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_frag(c, al, bh0, bh1);
  mma_frag(c, ah, bl0, bl1);
  mma_frag(c, ah, bh0, bh1);
}

// Per-point products over the tile's 64 points: out[p][n] = sum_k
// A[p][k] B[k][n]. A: k-block kb is tile rows arow(kb) .. + 7. B: the
// packed layer Wp with NP tile pairs. Rows m of an m-tile are the point
// columns 2g (m = g) and 2g + 1 (m = g + 8) of its 16. The block's jobs
// (NTJ column tiles of MT = 2 m-tiles, of NTILES column tiles in all) are
// job0, job0 + jstep, ..; epi(mi, j, c) takes the accumulator of m-tile
// mi, column tile j.
template <int KB, int NP, int NTILES, int NTJ, class ARow, class Epi>
__device__ __forceinline__ void k2_points(const float* T, ARow arow,
                                          const float* __restrict__ Wp,
                                          int job0, int jstep, Epi epi) {
  constexpr int MT = 2, NG = (NTILES + NTJ - 1) / NTJ, JOBS = NG * 2;
  static_assert((NTJ == 2 || NTJ == 4) && NTILES <= 2 * NP, "jobs");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float4* W4 = reinterpret_cast<const float4*>(Wp);
  for (int job = job0; job < JOBS; job += jstep) {
    const int ng = job / 2, m0 = (job % 2) * MT;
    // b[0 .. 2 NTJ - 1]: the hi parts of this job's B fragments (tile
    // pairs ng NTJ / 2 ..), then their lo parts
    auto load_b = [&](int kb, float (&b)[4 * NTJ]) {
#pragma unroll
      for (int h = 0; h < NTJ / 2; ++h) {
        const float4* w =
            W4 + ((kb * NP + ng * (NTJ / 2) + h) * 32 + lane) * 2;
        const float4 u = __ldg(w), v = __ldg(w + 1);
        b[4 * h] = u.x; b[4 * h + 1] = u.y; b[4 * h + 2] = u.z;
        b[4 * h + 3] = u.w;
        b[2 * NTJ + 4 * h] = v.x; b[2 * NTJ + 4 * h + 1] = v.y;
        b[2 * NTJ + 4 * h + 2] = v.z; b[2 * NTJ + 4 * h + 3] = v.w;
      }
    };
    float c[MT][NTJ][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NTJ; ++j)
        c[mi][j][0] = c[mi][j][1] = c[mi][j][2] = c[mi][j][3] = 0.f;
    float bq[2][4 * NTJ];                    // one k-block ahead
    load_b(0, bq[0]);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      if (kb + 1 < KB) load_b(kb + 1, bq[(kb + 1) & 1]);
      uint32_t bh[2 * NTJ], bl[2 * NTJ];
#pragma unroll
      for (int i = 0; i < 2 * NTJ; ++i) {
        bh[i] = __float_as_uint(bq[kb & 1][i]);
        bl[i] = __float_as_uint(bq[kb & 1][2 * NTJ + i]);
      }
      uint32_t ah[MT][4], al[MT][4];
      const int r = arow(kb);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int col = 16 * (m0 + mi) + 2 * g;
        const float2 u = k2_ld2(T, r + t, col), v = k2_ld2(T, r + t + 4, col);
        const float a[4] = {u.x, u.y, v.x, v.y};
        split4(a, ah[mi], al[mi]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NTJ; ++j)
          mma_frag(c[mi][j], al[mi], bh[2 * j], bh[2 * j + 1]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NTJ; ++j)
          mma_frag(c[mi][j], ah[mi], bl[2 * j], bl[2 * j + 1]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NTJ; ++j)
          mma_frag(c[mi][j], ah[mi], bh[2 * j], bh[2 * j + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NTJ; ++j) epi(m0 + mi, ng * NTJ + j, c[mi][j]);
  }
}

// A single-k-block product (K = 8: d logits or g_rgb through a narrow
// layer's transpose) of all four m-tiles with the column tiles 2 ng and
// 2 ng + 1, whose B fragments' hi and lo parts wh, wl (this lane's) were
// loaded ahead; A is tile rows r .. r + 7; epi as in k2_points.
template <class Epi>
__device__ __forceinline__ void k2_points_kb1(const float* T, int r,
                                              float4 wh, float4 wl, int ng,
                                              Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t bh[4] = {__float_as_uint(wh.x), __float_as_uint(wh.y),
                          __float_as_uint(wh.z), __float_as_uint(wh.w)};
  const uint32_t bl[4] = {__float_as_uint(wl.x), __float_as_uint(wl.y),
                          __float_as_uint(wl.z), __float_as_uint(wl.w)};
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int col = 16 * mi + 2 * g;
    const float2 u = k2_ld2(T, r + t, col), v = k2_ld2(T, r + t + 4, col);
    const float a[4] = {u.x, u.y, v.x, v.y};
    split4(a, ah[mi], al[mi]);
  }
  float c[4][2][4] = {};
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      mma_frag(c[mi][j], al[mi], bh[2 * j], bh[2 * j + 1]);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      mma_frag(c[mi][j], ah[mi], bl[2 * j], bl[2 * j + 1]);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      mma_frag(c[mi][j], ah[mi], bh[2 * j], bh[2 * j + 1]);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j) epi(mi, 2 * ng + j, c[mi][j]);
}

// Weight gradient, points as the reduction axis: acc[m][i] += sum over the
// tile's points of D[r][p] X[8 (j0 + i) + n][p] for the rows r of two
// m-tiles of D (m-tile m at tile rows dm[m] + 0..15) and the column tiles
// j0 .. j0 + nj - 1 (nj <= NJ) of X at tile rows xrow(j) + 0..7. k-block
// kb's points t and t + 4 are the columns 8 kb + 2t and + 1 (one 8-byte
// load per operand row); each X fragment serves both m-tiles.
template <int NJ, class XRow>
__device__ __forceinline__ void k2_wgrad(const float* T, const int (&dm)[2],
                                         XRow xrow, int j0, int nj,
                                         float (&acc)[2][NJ][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kb = 0; kb < K2_KB; ++kb) {
    const int col = 8 * kb + 2 * t;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float2 u = k2_ld2(T, dm[m] + g, col);
      const float2 v = k2_ld2(T, dm[m] + 8 + g, col);
      const float a[4] = {u.x, v.x, u.y, v.y};
      split4(a, ah[m], al[m]);
    }
#pragma unroll
    for (int i0 = 0; i0 < NJ; i0 += 4) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i0 + i < NJ && i0 + i < nj) {
          const float2 b = k2_ld2(T, xrow(j0 + i0 + i) + g, col);
          split_tf32(b.x, bh[i][0], bl[i][0]);
          split_tf32(b.y, bh[i][1], bl[i][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i0 + i < NJ && i0 + i < nj)
            mma_frag(acc[m][i0 + i], al[m], bh[i][0], bh[i][1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i0 + i < NJ && i0 + i < nj)
            mma_frag(acc[m][i0 + i], ah[m], bl[i][0], bl[i][1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i0 + i < NJ && i0 + i < nj)
            mma_frag(acc[m][i0 + i], ah[m], bh[i][0], bh[i][1]);
    }
  }
}

// The narrow layers' weight gradients on the CUDA cores, in float32:
// thread i < 129 sums h2 row i (row 128 the ones row: the bias) against
// the 5 d-logit rows, threads 129 .. 244 row i - 129 of [h1 rgb | PE | 1]
// (the tile's PE at row pe)
// against the 3 g_rgb rows, over the tile's points (16 bytes a load: four
// consecutive columns stay contiguous under the swizzle); sum[c], this
// thread's running sums, stay in shared memory across the tiles.
template <class K>
__device__ __forceinline__ void k2_wgrad_narrow(const float* T, int pe,
                                                float* sum) {
  const int i = threadIdx.x, r = i - (HBR + 1);
  const bool sdf1 = i <= HBR;
  if (!sdf1 && r > NRGB + PE) return;
  const int xr = sdf1 ? K::R_H2 + i : r < NRGB ? K::R_H1R + r : pe + r - NRGB;
  const int dr = sdf1 ? K::R_LOG : K::R_G;
  float acc[NCLS] = {};
#pragma unroll 4
  for (int p = 0; p < K2_P; p += 4) {
    const float4 x = *reinterpret_cast<const float4*>(T + k2_at(xr, p));
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
      if (!sdf1 && c >= 3) break;
      const float4 d = *reinterpret_cast<const float4*>(T + k2_at(dr + c, p));
      acc[c] = fmaf(x.w, d.w, fmaf(x.z, d.z, fmaf(x.y, d.y,
                                                  fmaf(x.x, d.x, acc[c]))));
    }
  }
#pragma unroll
  for (int c = 0; c < NCLS; ++c)
    if (sdf1 || c < 3) sum[c] += acc[c];
}

// A wide layer's bias gradient on the CUDA cores, in float32: the sum over
// the tile's points of gradient row r (tile row row(r), r < 128) added to
// sum[r], by thread 128 h + r.
template <class Row>
__device__ __forceinline__ void k2_bias_sum(const float* T, int h, Row row,
                                            float* sum) {
  const int r = threadIdx.x - 128 * h;
  if (r < 0 || r >= 128) return;
  const int tr = row(r);
  float acc = 0.f;
#pragma unroll 4
  for (int p = 0; p < K2_P; p += 4) {
    const float4 v = *reinterpret_cast<const float4*>(T + k2_at(tr, p));
    acc += (v.x + v.y) + (v.z + v.w);
  }
  *sum += acc;
}

// This warp's shared-memory dW^T tiles of a wide layer (slot m NJ + i
// for m-tile m, column tile j0 + i) through k2_wgrad: loaded,
// accumulated over the tile, stored.
template <int NJ, class XRow>
__device__ __forceinline__ void k2_wgrad_smem(const float* T,
                                              const int (&dm)[2], XRow xrow,
                                              int j0, int nj, float4* slot) {
  float acc[2][NJ][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const float4 v = slot[(m * NJ + i) * 32];
      acc[m][i][0] = v.x; acc[m][i][1] = v.y; acc[m][i][2] = v.z;
      acc[m][i][3] = v.w;
    }
  k2_wgrad<NJ>(T, dm, xrow, j0, nj, acc);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < NJ; ++i)
      slot[(m * NJ + i) * 32] = make_float4(acc[m][i][0], acc[m][i][1],
                                            acc[m][i][2], acc[m][i][3]);
}

// 4-byte cp.async into shared memory, zero-filled unless `ok`
__device__ __forceinline__ void k2_cp4(float* dst, const float* src,
                                       bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16-byte cp.async into shared memory of the first `n` floats (0..4),
// the rest zero-filled
__device__ __forceinline__ void k2_cp16(float* dst, const float* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(4 * n));
}

__device__ __forceinline__ bool k2_aligned16(const void* a, const void* b,
                                             const void* c) {
  return (((size_t)a | (size_t)b | (size_t)c) & 15) == 0;
}

// Start copying rows of a tile's inputs (points n0 .. n0 + nv - 1) in
// the background, one commit group a thread: with EMBED the embed into its
// rows, else x and g into the XN rows; padding columns read zeros. Four
// points a copy where every row is 16-byte aligned (N a multiple of 4,
// aligned arrays; four consecutive columns stay contiguous under the
// swizzle), else one.
template <class K, bool EMBED>
__device__ __forceinline__ void k2_fetch(float* T, const float* __restrict__ x,
                                         const float* __restrict__ g,
                                         const float* __restrict__ embed,
                                         int N, int n0, int nv) {
  const size_t S = N;
  constexpr int ROWS = EMBED ? K::E : 3 + 5 + NCLS;
  auto src_row = [&](int r) {
    return EMBED ? embed + r * S : r < 3 ? x + r * S : g + (r - 3) * S;
  };
  const int base = EMBED ? K::R_EMB : K::R_XN;
  if (N % 4 == 0 && k2_aligned16(x, g, embed)) {
    for (int it = threadIdx.x; it < ROWS * K2_P / 4; it += K2_NT) {
      const int r = it / (K2_P / 4), p = 4 * (it % (K2_P / 4));
      const int n = max(0, min(4, nv - p));
      k2_cp16(T + k2_at(base + r, p), src_row(r) + n0 + (n > 0 ? p : 0), n);
    }
  } else {
    for (int it = threadIdx.x; it < ROWS * K2_P; it += K2_NT) {
      const int r = it / K2_P, p = it % K2_P;
      k2_cp4(T + k2_at(base + r, p), src_row(r) + n0 + (p < nv ? p : 0),
             p < nv);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's copies.
__device__ __forceinline__ void k2_fetch_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A fetched tile's PE rows at row pe (x, then per axis and band sin, cos;
// padding columns at x = 0.5).
template <class K>
__device__ __forceinline__ void k2_pe(float* T, int pe, int nv) {
  for (int it = threadIdx.x; it < (3 + 3 * NFREQ) * K2_P; it += K2_NT) {
    const int r = it / K2_P, p = it % K2_P;
    const int d = r < 3 ? r : (r - 3) % 3;
    const float xd = p < nv ? T[k2_at(K::R_XN + d, p)] : 0.5f;
    if (r < 3) {
      T[k2_at(pe + r, p)] = xd;
    } else {
      const int j = (r - 3) / 3;
      float sn, cs;
      sincosf(xd * pe_freq(j), &sn, &cs);
      T[k2_at(pe + 3 + d * 2 * NFREQ + 2 * j, p)] = sn;
      T[k2_at(pe + 3 + d * 2 * NFREQ + 2 * j + 1, p)] = cs;
    }
  }
}

// A fetched tile's rgb cotangent rows.
template <class K>
__device__ __forceinline__ void k2_g(float* T) {
  for (int it = threadIdx.x; it < 3 * K2_P; it += K2_NT) {
    const int c = it / K2_P, p = it % K2_P;
    T[k2_at(K::R_G + c, p)] = T[k2_at(K::R_XN + 3 + c, p)];
  }
}

// K2 per-point pass (see the note at the top). WG adds the weight
// gradients; each block writes its partial ([gridDim.x, GRAD_SIZE], every
// entry) once at the end. Without WG (GO: pose gradients only) it
// computes d_x and d_embed alone.
template <class Sh, bool WG>
__global__ void __launch_bounds__(K2_NT, 1)
    decoder_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ embed, int N, DecoderW dw,
                       const float* __restrict__ wt,
                       float* __restrict__ partials,
                       float* __restrict__ d_x, float* __restrict__ d_embed) {
  using K = K2Layout<Sh>;
  extern __shared__ float4 sm4[];
  float* T = reinterpret_cast<float*>(sm4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float4* slots = reinterpret_cast<float4*>(T + K::ROWS * K2_LD) +
                  warp * K2_SLOTS * 32 + lane;
  const size_t S = N;
  const int n_tiles = (N + K2_P - 1) / K2_P;
  // rows that stay constant: the ones rows and the zero rows around them
  for (int it = threadIdx.x; it < 8 * K2_P; it += K2_NT) {
    const int r = it / K2_P, p = it % K2_P;
    const float one = r == 0 ? 1.f : 0.f;
    if (r < PE_ROWS - PE) {
      T[k2_at(K::R_PE + PE + r, p)] = one;
      T[k2_at(K::R_PE2 + PE + r, p)] = one;
    }
    if (r < K::EF - K::E) T[k2_at(K::R_EMB + K::E + r, p)] = 0.f;
    T[k2_at(K::R_H2 + HBR + r, p)] = one;
    if (r >= NCLS) T[k2_at(K::R_LOG + r, p)] = 0.f;
    if (r >= 3) T[k2_at(K::R_G + r, p)] = 0.f;
  }
  // this thread's running sums on the CUDA cores (k2_wgrad_narrow,
  // k2_bias_sum)
  float* nsum = T + K::ROWS * K2_LD + K2_WARPS * K2_SLOTS * 128 +
                threadIdx.x * 8;
  if (WG) {
#pragma unroll
    for (int s = 0; s < K2_SLOTS; ++s) slots[s * 32] = float4{};
#pragma unroll
    for (int c = 0; c < 8; ++c) nsum[c] = 0.f;
  }
  // this warp's dW^T tiles of the wide layers: output features 32 mp ..
  // 32 mp + 31 (two m-tiles), column tiles of half hc of each layer's input
  const int mp = warp & 3, hc = warp >> 2;
  constexpr int H1 = (K::NJ_1 + 1) / 2, HS0 = (K::NJ_S0 + 1) / 2,
                H0 = (K::NJ_0 + 1) / 2;
  const int j1 = hc * H1, n1 = hc ? K::NJ_1 - H1 : H1;
  const int js0 = hc * HS0, ns0 = hc ? K::NJ_S0 - HS0 : HS0;
  const int jw0 = hc * H0, nw0 = hc ? K::NJ_0 - H0 : H0;
  float acc1[2][H1][4], accs0[2][HS0][4];       // trunk1, sdf0 dW^T
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int i = 0; i < H1; ++i)
      acc1[m][i][0] = acc1[m][i][1] = acc1[m][i][2] = acc1[m][i][3] = 0.f;
#pragma unroll
    for (int i = 0; i < HS0; ++i)
      accs0[m][i][0] = accs0[m][i][1] = accs0[m][i][2] = accs0[m][i][3] =
          0.f;
  }
  const int col0 = 2 * gq;                   // + 16 mi: an m-tile's columns
  auto rows_at = [](int base) {
    return [base](int kb) { return base + 8 * kb; };
  };

  // the first tile's inputs; the tiles' PE rows alternate between two
  // blocks, the next tile's made while this one's are still read
  k2_fetch<K, true>(T, x, g, embed, N, blockIdx.x * K2_P,
                    min(K2_P, N - blockIdx.x * K2_P));
  k2_fetch<K, false>(T, x, g, embed, N, blockIdx.x * K2_P,
                     min(K2_P, N - blockIdx.x * K2_P));
  k2_fetch_wait();
  __syncthreads();
  k2_pe<K>(T, K::R_PE, min(K2_P, N - blockIdx.x * K2_P));
  k2_g<K>(T);
  __syncthreads();
  int pe = K::R_PE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = tile * K2_P, nv = min(K2_P, N - n0);
    const int next = tile + gridDim.x;
    const int pe_next = pe == K::R_PE ? K::R_PE2 : K::R_PE;
    // ---- forward recompute: h0, h1, h2 ----
    k2_points<7, 8, 16, 4>(
        T, rows_at(pe), wt + K::P_F1, warp, K2_WARPS,
        [&](int mi, int j, const float (&c)[4]) {
          const int n = 8 * j + 2 * tq, col = 16 * mi + col0;
          const float b0 = __ldg(dw.b0 + n), b1 = __ldg(dw.b0 + n + 1);
          k2_st2(T, K::R_H0 + n, col, fmaxf(c[0] + b0, 0.f),
                 fmaxf(c[2] + b0, 0.f));
          k2_st2(T, K::R_H0 + n + 1, col, fmaxf(c[1] + b1, 0.f),
                 fmaxf(c[3] + b1, 0.f));
        });
    __syncthreads();
    k2_points<16, 8, 16, 4>(
        T, rows_at(K::R_H0), wt + K::P_F2, warp, K2_WARPS,
        [&](int mi, int j, const float (&c)[4]) {
          const int n = 8 * j + 2 * tq, col = 16 * mi + col0;
          const int r = n < NSDF ? K::R_H1S + n : K::R_H1R + n - NSDF;
          const float b0 = __ldg(dw.b1 + n), b1 = __ldg(dw.b1 + n + 1);
          k2_st2(T, r, col, c[0] + b0, c[2] + b0);
          k2_st2(T, r + 1, col, c[1] + b1, c[3] + b1);
        });
    __syncthreads();
    k2_points<K::KB_F3, 8, 16, 4>(
        T, rows_at(K::R_H1S), wt + K::P_F3, warp, K2_WARPS,
        [&](int mi, int j, const float (&c)[4]) {
          const int n = 8 * j + 2 * tq, col = 16 * mi + col0;
          const float b0 = __ldg(dw.bs0 + n), b1 = __ldg(dw.bs0 + n + 1);
          k2_st2(T, K::R_H2 + n, col, fmaxf(c[0] + b0, 0.f),
                 fmaxf(c[2] + b0, 0.f));
          k2_st2(T, K::R_H2 + n + 1, col, fmaxf(c[1] + b1, 0.f),
                 fmaxf(c[3] + b1, 0.f));
        });
    __syncthreads();
    // ---- logits: warp w sums k-blocks 8 hc .. 8 hc + 7 of m-tile w % 4;
    // the pair w, w + 4 swap halves (over d h2's free rows), and each runs
    // the softmax head's backward on its quads for one of a thread's two
    // points (m = g on warps 0..3, g + 8 on 4..7): d logits ----
    {
      const int mi = warp & 3, col = 16 * mi + col0;
      const float2* Wl = reinterpret_cast<const float2*>(wt + K::P_F4);
      // [k-block][lane]: hi parts of column tile 0 at float2 4 (kb 32 +
      // lane), lo parts 2 further
      const bool v0 = 2 * tq < NCLS, v1 = 2 * tq + 1 < NCLS;
      const float bs0 = v0 ? __ldg(dw.bs1 + 2 * tq) : 0.f;
      const float bs1 = v1 ? __ldg(dw.bs1 + 2 * tq + 1) : 0.f;
      float2 wq[8], wl[8];                   // every k-block's, up front
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        wq[i] = __ldg(Wl + ((8 * hc + i) * 32 + lane) * 4);
        wl[i] = __ldg(Wl + ((8 * hc + i) * 32 + lane) * 4 + 2);
      }
      float cl[4][4] = {};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kb = 8 * hc + i;
        const float2 u = k2_ld2(T, K::R_H2 + 8 * kb + tq, col);
        const float2 v = k2_ld2(T, K::R_H2 + 8 * kb + tq + 4, col);
        const float a[4] = {u.x, u.y, v.x, v.y};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
        mma3(cl[i & 3], ah, al, __float_as_uint(wq[i].x),
             __float_as_uint(wq[i].y), __float_as_uint(wl[i].x),
             __float_as_uint(wl[i].y));
      }
      float lg[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        lg[e] = (cl[0][e] + cl[1][e]) + (cl[2][e] + cl[3][e]);
      float4* halves = reinterpret_cast<float4*>(T + K::R_DH2 * K2_LD);
      halves[(hc * 4 + mi) * 32 + lane] =
          make_float4(lg[0], lg[1], lg[2], lg[3]);
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + mi));   // warps w, w + 4
      const float4 h0 = halves[mi * 32 + lane];
      const float4 h1 = halves[(4 + mi) * 32 + lane];
      const float l0 = (hc ? h0.z + h1.z : h0.x + h1.x) + bs0;
      const float l1 = (hc ? h0.w + h1.w : h0.y + h1.y) + bs1;
      const float ninf = __int_as_float(0xff800000);
      const float ln2 = 0.69314718055994530942f, eps = 1e-5f;
      const float m = quad_max(fmaxf(v0 ? l0 : ninf, v1 ? l1 : ninf));
      const float e0 = v0 ? expf(l0 - m) : 0.f, e1 = v1 ? expf(l1 - m) : 0.f;
      const float s = quad_sum(e0 + e1);
      const float p0 = e0 / s, p1 = e1 / s;
      const int p = col + hc;                // g rows 3.. fetched, 0 past nv
      const float g_sdf = T[k2_at(K::R_XN + 6, p)];
      const float g_ent = T[k2_at(K::R_XN + 7, p)];
      float gp[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * tq + h;
        const float pc = h ? p1 : p0;
        const float dent = -(log2f(pc + eps) + pc / ((pc + eps) * ln2));
        gp[h] = (h ? v1 : v0)
                    ? T[k2_at(K::R_XN + 8 + c, p)] +
                          g_sdf * (2.0f / (float)(NCLS - 1)) * (float)c +
                          g_ent * dent
                    : 0.f;
      }
      const float dot = quad_sum(gp[0] * p0 + gp[1] * p1);
      if (v0) T[k2_at(K::R_LOG + 2 * tq, p)] = p0 * (gp[0] - dot);
      if (v1) T[k2_at(K::R_LOG + 2 * tq + 1, p)] = p1 * (gp[1] - dot);
    }
    __syncthreads();
    // ---- the next tile's x and g start to arrive (the softmax has read
    // this tile's); sdf1's and rgb's weight gradients; d h2 = (Ws1 d
    // logits) (h2 > 0) (its B fragments loaded first: the load overlaps
    // the weight gradients) ----
    if (next < n_tiles)
      k2_fetch<K, false>(T, x, g, embed, N, next * K2_P,
                         min(K2_P, N - next * K2_P));
    {
      const float4* pb = reinterpret_cast<const float4*>(wt + K::P_B1) +
                         (warp * 32 + lane) * 2;
      const float4 wbh = __ldg(pb), wbl = __ldg(pb + 1);
      if (WG) k2_wgrad_narrow<K>(T, pe, nsum);
      k2_points_kb1(T, K::R_LOG, wbh, wbl, warp,
        [&](int mi, int j, const float (&c)[4]) {
          const int n = 8 * j + 2 * tq, col = 16 * mi + col0;
          const float2 h = k2_ld2(T, K::R_H2 + n, col);
          const float2 h1 = k2_ld2(T, K::R_H2 + n + 1, col);
          k2_st2(T, K::R_DH2 + n, col, h.x > 0.f ? c[0] : 0.f,
                 h.y > 0.f ? c[2] : 0.f);
          k2_st2(T, K::R_DH2 + n + 1, col, h1.x > 0.f ? c[1] : 0.f,
                 h1.y > 0.f ? c[3] : 0.f);
        });
    }
    __syncthreads();
    // ---- sdf0's weight gradient; d sdf_in = Ws0 d h2 -> d h1 sdf, d embed
    // (over h2's rows); d h1 rgb = Wr[:64] g_rgb (over h1 rgb's rows) ----
    const float4* pr = reinterpret_cast<const float4*>(wt + K::P_B2R) +
                       ((warp & 3) * 32 + lane) * 2;
    const float4 wrh = __ldg(pr), wrl = __ldg(pr + 1);
    if (WG) {
      k2_wgrad<HS0>(T, {K::R_DH2 + 32 * mp, K::R_DH2 + 32 * mp + 16},
                    rows_at(K::R_H1S), js0, ns0, accs0);
      k2_bias_sum(T, 0, [](int r) { return K::R_DH2 + r; }, nsum + 5);
    }
    k2_points<16, K::NP_B2, K::NT_B2, 2>(
        T, rows_at(K::R_DH2), wt + K::P_B2, warp, K2_WARPS,
        [&](int mi, int j, const float (&c)[4]) {
          const int n = 8 * j + 2 * tq, col = 16 * mi + col0;
          if (n >= K::NIN_S0) return;        // 64 + E is even
          k2_st2(T, K::R_H2 + n, col, c[0], c[2]);
          k2_st2(T, K::R_H2 + n + 1, col, c[1], c[3]);
        });
    if (warp >= 4)
      k2_points_kb1(T, K::R_G, wrh, wrl, warp - 4,
                    [&](int mi, int j, const float (&c)[4]) {
                      const int n = 8 * j + 2 * tq, col = 16 * mi + col0;
                      k2_st2(T, K::R_H1R + n, col, c[0], c[2]);
                      k2_st2(T, K::R_H1R + n + 1, col, c[1], c[3]);
                    });
    k2_fetch_wait();
    __syncthreads();
    // ---- d embed out; the next tile's inputs start to arrive; trunk1's
    // weight gradient; d h0 = (W1 d h1) (h0 > 0) ----
    if (N % 4 == 0 && nv == K2_P && k2_aligned16(d_embed, d_embed, d_embed)) {
      for (int it = threadIdx.x; it < K::E * K2_P / 4; it += K2_NT) {
        const int e = it / (K2_P / 4), p = 4 * (it % (K2_P / 4));
        *reinterpret_cast<float4*>(d_embed + e * S + n0 + p) =
            *reinterpret_cast<const float4*>(T + k2_at(K::R_H2 + NSDF + e, p));
      }
    } else {
      for (int it = threadIdx.x; it < K::E * K2_P; it += K2_NT) {
        const int e = it / K2_P, p = it % K2_P;
        if (p < nv) d_embed[e * S + n0 + p] = T[k2_at(K::R_H2 + NSDF + e, p)];
      }
    }
    if (next < n_tiles)
      k2_fetch<K, true>(T, x, g, embed, N, next * K2_P,
                        min(K2_P, N - next * K2_P));
    auto dh1_rows = [](int kb) {             // d h1 = [d h1 sdf | d h1 rgb]
      return kb < NSDF / 8 ? K::R_H2 + 8 * kb : K::R_H1R + 8 * kb - NSDF;
    };
    if (WG) {
      const int d0 = dh1_rows(4 * mp);     // 32 rows in one of the halves
      k2_wgrad<H1>(T, {d0, d0 + 16}, rows_at(K::R_H0), j1, n1, acc1);
      k2_bias_sum(T, 1, [&](int r) { return dh1_rows(r / 8) + r % 8; },
                  nsum + 6);
    }
    k2_points<16, 8, 16, 4>(
        T, dh1_rows, wt + K::P_B3, warp, K2_WARPS,
        [&](int mi, int j, const float (&c)[4]) {
          const int n = 8 * j + 2 * tq, col = 16 * mi + col0;
          const float2 h = k2_ld2(T, K::R_H0 + n, col);
          const float2 h1 = k2_ld2(T, K::R_H0 + n + 1, col);
          k2_st2(T, K::R_DH2 + n, col, h.x > 0.f ? c[0] : 0.f,
                 h.y > 0.f ? c[2] : 0.f);
          k2_st2(T, K::R_DH2 + n + 1, col, h1.x > 0.f ? c[1] : 0.f,
                 h1.y > 0.f ? c[3] : 0.f);
        });
    if (next < n_tiles) k2_pe<K>(T, pe_next, min(K2_P, N - next * K2_P));
    __syncthreads();
    // ---- trunk0's weight gradient; d pe = W0 d h0 + Wr[64:] g_rgb (over
    // h0's rows) ----
    if (WG)
      k2_wgrad_smem<H0>(T, {K::R_DH2 + 32 * mp, K::R_DH2 + 32 * mp + 16},
                        rows_at(pe), jw0, nw0, slots);
    k2_points<17, 4, 7, 2>(
        T, [](int kb) { return kb < HID / 8 ? K::R_DH2 + 8 * kb : K::R_G; },
        wt + K::P_B4, warp, K2_WARPS,
        [&](int mi, int j, const float (&c)[4]) {
          const int n = 8 * j + 2 * tq, col = 16 * mi + col0;
          k2_st2(T, K::R_H0 + n, col, c[0], c[2]);
          k2_st2(T, K::R_H0 + n + 1, col, c[1], c[3]);
        });
    k2_fetch_wait();
    __syncthreads();
    // ---- d x through the PE: the raw-x rows plus the sin/cos chain, with
    // the tile's own sin and cos from its PE rows; the next tile's rgb
    // cotangent ----
    for (int it = threadIdx.x; it < 3 * K2_P; it += K2_NT) {
      const int d = it / K2_P, p = it % K2_P;
      if (p >= nv) continue;
      float acc = T[k2_at(K::R_H0 + d, p)];
#pragma unroll
      for (int j = 0; j < NFREQ; ++j) {
        const int r = 3 + d * 2 * NFREQ + 2 * j;      // sin; cos at r + 1
        acc += (T[k2_at(K::R_H0 + r, p)] * T[k2_at(pe + r + 1, p)] -
                T[k2_at(K::R_H0 + r + 1, p)] * T[k2_at(pe + r, p)]) *
               pe_freq(j);
      }
      d_x[d * S + n0 + p] = acc;
    }
    if (next < n_tiles) k2_g<K>(T);
    __syncthreads();
    pe = pe_next;
  }
  if (!WG) return;
  // ---- the block's partial: every entry of the flat gradient once ----
  float* part = partials + (size_t)blockIdx.x * K::GRAD_SIZE;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = 32 * mp + 16 * m + gq + 8 * (e >> 1);
      const int i0 = 2 * tq + (e & 1);
#pragma unroll
      for (int i = 0; i < H1; ++i) {         // trunk1: in 0..127
        const int in = 8 * (j1 + i) + i0;
        if (i < n1 && in < HID)
          part[K::OFF_W1 + in * (NSDF + NRGB) + o] = acc1[m][i][e];
      }
#pragma unroll
      for (int i = 0; i < HS0; ++i) {        // sdf0: in 0..63+E
        const int in = 8 * (js0 + i) + i0;
        if (i < ns0 && in < K::NIN_S0)
          part[K::OFF_WS0 + in * HBR + o] = accs0[m][i][e];
      }
#pragma unroll
      for (int i = 0; i < H0; ++i) {         // trunk0: in 0..50, bias 51
        const int in = 8 * (jw0 + i) + i0;
        const float4 v = slots[(m * H0 + i) * 32];
        const float c[4] = {v.x, v.y, v.z, v.w};
        if (i < nw0 && in <= PE) part[K::OFF_W0 + in * HID + o] = c[e];
      }
    }
  // the bias rows of sdf0 and trunk1 (k2_bias_sum) and the narrow layers
  // (k2_wgrad_narrow): thread ti's sums
  const int ti = threadIdx.x;
  if (ti < HBR) part[K::OFF_WS0 + K::NIN_S0 * HBR + ti] = nsum[5];
  else part[K::OFF_W1 + HID * (NSDF + NRGB) + ti - HBR] = nsum[6];
  if (ti <= HBR) {
#pragma unroll
    for (int c = 0; c < NCLS; ++c) part[K::OFF_WS1 + ti * NCLS + c] = nsum[c];
  } else if (ti - (HBR + 1) <= NRGB + PE) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      part[K::OFF_WR + (ti - (HBR + 1)) * 3 + c] = nsum[c];
  }
}

// out[i] = the sum of the first `splits` partials' entry i, in block order
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

template <class Sh>
int decoder_pack_weights(DecoderW dw, float* wt, cudaStream_t st) {
  k2_pack_weights_kernel<Sh>
      <<<(K2Layout<Sh>::WT_SIZE + 255) / 256, 256, 0, st>>>(dw, wt);
  return (int)cudaGetLastError();
}

// grads: flat [GRAD_SIZE] = per layer (trunk0, trunk1, rgb, sdf0, sdf1) the
// [in+1, out] block of w rows followed by the bias row. partials:
// [splits, GRAD_SIZE] scratch (splits: the device's SM count); the grid
// has min(tiles, splits) blocks, each writing its row once. wt: scratch of
// WT_SIZE floats for the packed weights. With weight_grads = 0 only d_x
// and d_embed are computed (partials and grads are not touched).
template <class Sh>
int decoder_backward(const float* x, const float* g, const float* embed,
                     int n, DecoderW dw, float* wt, float* partials,
                     int splits, float* d_x, float* d_embed, float* grads,
                     int weight_grads, cudaStream_t st) {
  using K = K2Layout<Sh>;
  if (n <= 0) return (int)cudaSuccess;
  static bool attr_set[MAX_DEVICES] = {};
  cudaError_t e = once_per_device(attr_set, [] {
    cudaError_t r = cudaFuncSetAttribute(
        decoder_bwd_kernel<Sh, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    return r != cudaSuccess
               ? r
               : cudaFuncSetAttribute(
                     decoder_bwd_kernel<Sh, true>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  });
  if (e != cudaSuccess) return (int)e;
  int err = decoder_pack_weights<Sh>(dw, wt, st);
  if (err != (int)cudaSuccess) return err;
  const int n_tiles = (n + K2_P - 1) / K2_P;
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
      partials, grid, K::GRAD_SIZE, grads);
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
  extern "C" int mf_decoder_pack_weights_##SUFFIX(MF_DECODER_ARGS, float* wt, \
                                                  void* stream) {            \
    return mf::decoder_pack_weights<SH>(                                     \
        mf::make_dw(w0, b0, w1, b1, wr, br, ws0, bs0, ws1, bs1), wt,         \
        (cudaStream_t)stream);                                               \
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
