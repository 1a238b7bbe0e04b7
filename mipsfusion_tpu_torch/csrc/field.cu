// K1: fused field forward, and K2: decoder backward.
//
// K1 replaces mipsfusion_tpu/ops/field_pallas.py field_query_pallas
// (_make_field_kernel). A block takes a tile of 64 points. One thread per
// point computes the Triplane+CP gather lookups and the 8-band PE into
// shared memory laid out [feature][point]; then the 256 threads run the
// decoder layer by layer as small matrix products on that tile, each
// thread a register tile of 8 (or 4) outputs x 4 points, so every weight
// load is used 4 times and every activation load 8 times; the softmax
// head is again one thread per point. Decoder weights (38.6k floats) are
// read through the read-only cache, nearly broadcast within a warp. Per
// point ~38k MACs against ~0.2 KB of point I/O: bound by the FMA and
// load-issue rate, not by device memory. 91 KB of shared memory per block
// allows 2 blocks (16 warps) per SM.
//
// K2 replaces field_pallas.py _decoder_bwd_call (_make_decoder_bwd_kernel).
// Four launches:
//   (0) transposed copies of W1, Ws0 and W0 for the backward products;
//   (a) a block of 64 points recomputes PE and decoder from x and the
//       saved embed (same tiled products as K1), runs the backward sweep
//       (the matrix products on transposed weight copies, ReLU masks from
//       the saved activations), writes d_embed and d_x(PE), and copies
//       every per-point activation/delta pair the weight gradients need
//       into a workspace [872, N] (points-minor, coalesced). Like K1 it
//       is latency-bound and needs two blocks (16 warps) per SM (K1 held
//       to one block per SM ran 1.7 times slower on an H100), so its tile
//       stays at 91 KB: h2 and then d h1 reuse h0's rows, and h0's ReLU
//       signs are kept as a 1 KB bitmask;
//   (b) the weight gradients dW = sum_n a_n d_n^T (bias = a row of ones)
//       as a tiled reduction over points, split over the point axis into
//       `splits` partial sums (the TPU summed across its sequential grid;
//       blocks on the H100 run in no order, so each split writes its own
//       partial);
//   (c) a fixed-order sum of the partials: deterministic, no atomics.
// (a) is bound like K1; (b) reads the 3.5 KB/point workspace about twice,
// so it is bound by device-memory bandwidth.
// Precision: float32 storage and math. Weight gradients come back in the
// plain parameter layout ([in, out] then the bias row), so nothing needs
// un-permuting (the TPU kernel permuted PE rows for its tiling).

#include "common.cuh"

namespace mf {

// out[j][p] = act(b[j] + sum_k in[k][p] * W[k * ldw + j]) for j < J and
// the BP points of a shared-memory tile [rows][BP]. Work item t computes
// TJ outputs x 4 points. Rows j >= split go to out1 (row j - split).
// b may be null (no bias); mask, if given, is a bitmask [J][BP / 32] of
// 32-bit words whose clear bits zero the output (a ReLU derivative);
// ACCUM adds to the existing output.
// W rows and b are 16-byte aligned (ldw % 4 == 0).
template <int J, int TJ, int BP, int NT, bool RELU, bool ACCUM>
__device__ __forceinline__ void tile_dense(const float* in, int K,
                                           const float* __restrict__ W,
                                           int ldw,
                                           const float* __restrict__ b,
                                           float* out0, float* out1 = nullptr,
                                           int split = J,
                                           const unsigned* mask = nullptr) {
  constexpr int TP = 4, NPT = BP / TP, NJ = J / TJ;
  static_assert(J % TJ == 0 && TJ % 4 == 0 && BP % 32 == 0, "tile shape");
  for (int t = threadIdx.x; t < NJ * NPT; t += NT) {
    const int j0 = (t / NPT) * TJ, p0 = (t % NPT) * TP;
    float acc[TJ][TP];
#pragma unroll
    for (int i = 0; i < TJ; ++i) {
      float bi = b ? __ldg(b + j0 + i) : 0.f;
#pragma unroll
      for (int q = 0; q < TP; ++q) acc[i][q] = bi;
    }
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(in + k * BP + p0);
      const float* wr = W + (size_t)k * ldw + j0;
#pragma unroll
      for (int i4 = 0; i4 < TJ; i4 += 4) {
        const float4 w = ld4(wr + i4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i4 + i][0] = fmaf(wv[i], a.x, acc[i4 + i][0]);
          acc[i4 + i][1] = fmaf(wv[i], a.y, acc[i4 + i][1]);
          acc[i4 + i][2] = fmaf(wv[i], a.z, acc[i4 + i][2]);
          acc[i4 + i][3] = fmaf(wv[i], a.w, acc[i4 + i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TJ; ++i) {
      const int j = j0 + i;
      float* o = (j < split ? out0 + j * BP : out1 + (j - split) * BP) + p0;
      float v[TP];
#pragma unroll
      for (int q = 0; q < TP; ++q) {
        v[q] = RELU ? fmaxf(acc[i][q], 0.f) : acc[i][q];
        const int pq = p0 + q;
        if (mask && !((mask[j * (BP / 32) + pq / 32] >> (pq % 32)) & 1u))
          v[q] = 0.f;
        if (ACCUM) v[q] += o[q];
      }
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Copy rows [rows][BP] of a tile to a points-minor array at column n0.
template <int BP, int NT>
__device__ __forceinline__ void tile_store(const float* src, int rows,
                                           float* dst, size_t ld, int n0,
                                           int nv) {
  for (int i = threadIdx.x; i < rows * BP; i += NT) {
    const int r = i / BP, p = i % BP;
    if (p < nv) dst[(size_t)r * ld + n0 + p] = src[r * BP + p];
  }
}

// Point coordinate d of tile column p (padding columns read 0.5).
__device__ __forceinline__ float tile_x(const float* __restrict__ x, int N,
                                        int n0, int nv, int d, int p) {
  return p < nv ? x[(size_t)d * N + n0 + p] : 0.5f;
}

// PE rows [51][BP] of a tile, as (row, point) work items over all threads.
template <int BP, int NT>
__device__ __forceinline__ void tile_pe(const float* __restrict__ x, int N,
                                        int n0, int nv, float* pe) {
  for (int it = threadIdx.x; it < (3 + 3 * NFREQ) * BP; it += NT) {
    const int r = it / BP, p = it % BP;
    if (r < 3) {
      pe[r * BP + p] = tile_x(x, N, n0, nv, r, p);
    } else {
      const int d = (r - 3) / NFREQ, j = (r - 3) % NFREQ;
      float sn, cs;
      sincosf(tile_x(x, N, n0, nv, d, p) * pe_freq(j), &sn, &cs);
      pe[(3 + d * 2 * NFREQ + 2 * j) * BP + p] = sn;
      pe[(3 + d * 2 * NFREQ + 2 * j + 1) * BP + p] = cs;
    }
  }
}

// Triplane + CP embed rows [48][BP] of a tile. Work item (part, point):
// part 0 / 1 the 4 features of scale 0 / 1, parts 2..11 four CP channels.
template <int BP, int NT>
__device__ __forceinline__ void tile_encode(const float* __restrict__ x,
                                            int N, int n0, int nv,
                                            const float* __restrict__ s0,
                                            const float* __restrict__ s1,
                                            const float* __restrict__ cp,
                                            float* emb) {
  constexpr int PARTS = 2 + CCP / 4;
  for (int it = threadIdx.x; it < PARTS * BP; it += NT) {
    const int part = it / BP, p = it % BP;
    const float xp[3] = {tile_x(x, N, n0, nv, 0, p),
                         tile_x(x, N, n0, nv, 1, p),
                         tile_x(x, N, n0, nv, 2, p)};
    float4 v;
    int row;
    if (part < 2) {
      v = part == 0 ? scale_lookup<R0>(s0, xp) : scale_lookup<R1>(s1, xp);
      row = part * FEAT;
    } else {
      const int c = (part - 2) * 4;
      v = cp_lookup4(cp, xp, c);
      row = 2 * FEAT + c;
    }
    emb[row * BP + p] = v.x;
    emb[(row + 1) * BP + p] = v.y;
    emb[(row + 2) * BP + p] = v.z;
    emb[(row + 3) * BP + p] = v.w;
  }
}

// Tile rows shared by K1 and K2: [h1_sdf 64 | embed 48 | h1_rgb 64 | pe 51]
// so that the sdf-branch input (rows 0..111) and the rgb-branch input
// (rows 112..226) are contiguous; then 128 rows for h0.
constexpr int ROW_SDF_IN = 0;
constexpr int ROW_EMB = NSDF;              // 64
constexpr int ROW_RGB_IN = NSDF + EMB;     // 112
constexpr int ROW_PE = ROW_RGB_IN + NRGB;  // 176
constexpr int ROW_H = ROW_PE + PE;         // 227
constexpr int K1_BP = 64;
constexpr int K1_NT = 256;
constexpr int K1_ROWS = ROW_H + HID;       // 355 (h2 reuses the h0 rows)

template <bool SDF_ONLY, bool RET_EMBED>
__global__ void __launch_bounds__(K1_NT)
    field_forward_kernel(const float* __restrict__ x, int N,
                         const float* __restrict__ s0,
                         const float* __restrict__ s1,
                         const float* __restrict__ cp, DecoderW dw,
                         float* __restrict__ out, float* __restrict__ embed) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  constexpr int BP = K1_BP, NT = K1_NT;
  const int n0 = blockIdx.x * BP;
  const int nv = min(BP, N - n0);
  const int p = threadIdx.x;
  tile_encode<BP, NT>(x, N, n0, nv, s0, s1, cp, sm + ROW_EMB * BP);
  tile_pe<BP, NT>(x, N, n0, nv, sm + ROW_PE * BP);
  __syncthreads();
  if (RET_EMBED) tile_store<BP, NT>(sm + ROW_EMB * BP, EMB, embed, N, n0, nv);
  tile_dense<HID, 8, BP, NT, true, false>(sm + ROW_PE * BP, PE, dw.w0, HID,
                                          dw.b0, sm + ROW_H * BP);      // h0
  __syncthreads();
  tile_dense<NSDF, 4, BP, NT, false, false>(sm + ROW_H * BP, HID, dw.w1,
                                            NSDF + NRGB, dw.b1,
                                            sm + ROW_SDF_IN * BP);      // h1 sdf
  if (!SDF_ONLY)
    tile_dense<NRGB, 4, BP, NT, false, false>(
        sm + ROW_H * BP, HID, dw.w1 + NSDF, NSDF + NRGB, dw.b1 + NSDF,
        sm + ROW_RGB_IN * BP);                                          // h1 rgb
  __syncthreads();
  tile_dense<HBR, 8, BP, NT, true, false>(sm + ROW_SDF_IN * BP, NSDF + EMB,
                                          dw.ws0, HBR, dw.bs0,
                                          sm + ROW_H * BP);             // h2
  __syncthreads();
  if (p >= nv) return;                        // no barriers below
  float logits[NCLS], prob[NCLS];
  dense_small<NCLS>(sm + ROW_H * BP + p, BP, HBR, dw.ws1, dw.bs1, logits);
  const float sdf = softmax_head(logits, prob);
  const int n = n0 + p;
  if (SDF_ONLY) {
    out[n] = sdf;
    return;
  }
  float rgb[3];
  dense_small<3>(sm + ROW_RGB_IN * BP + p, BP, NRGB + PE, dw.wr, dw.br, rgb);
  float ent = 0.f;
#pragma unroll
  for (int c = 0; c < NCLS; ++c) ent -= prob[c] * log2f(prob[c] + 1e-5f);
  out[n] = rgb[0];
  out[(size_t)N + n] = rgb[1];
  out[2 * (size_t)N + n] = rgb[2];
  out[3 * (size_t)N + n] = sdf;
  out[4 * (size_t)N + n] = ent;
#pragma unroll
  for (int c = 0; c < NCLS; ++c) out[(size_t)(5 + c) * N + n] = prob[c];
}

// ---------------------------------------------------------------- K2 ----
// workspace rows [WS_ROWS, N]; rows 0..226 have the tile layout above
constexpr int WS_H0 = ROW_H;                 // 227
constexpr int WS_H2 = WS_H0 + HID;           // 355
constexpr int WS_DH0 = WS_H2 + HBR;          // 483
constexpr int WS_DH1 = WS_DH0 + HID;         // 611: d h1_sdf 64 | d h1_rgb 64
constexpr int WS_DH2 = WS_DH1 + NSDF + NRGB; // 739
constexpr int WS_DLOG = WS_DH2 + HBR;        // 867
constexpr int WS_ROWS = WS_DLOG + NCLS;      // 872

// transposed weight copies (scratch): Ws0^T [128][112], W1^T [128][128],
// W0^T [128][56] (PE rows padded to 56, zeros)
constexpr int PE_PAD = 56;
constexpr int WT_S0 = 0;
constexpr int WT_1 = WT_S0 + HBR * (NSDF + EMB);
constexpr int WT_0 = WT_1 + (NSDF + NRGB) * HID;
constexpr int WT_SIZE = WT_0 + HID * PE_PAD;

__global__ void transpose_weights_kernel(DecoderW dw, float* __restrict__ wt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < HBR * (NSDF + EMB)) {              // Ws0 [112][128] -> [128][112]
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

constexpr int K2_BP = 64;
constexpr int K2_NT = 256;
// tile regions: A = rows 0..231 (the forward tile rows 0..226, then the
// backward's d h2, d embed and d pe), B = h0, then h2, then d h1; after
// the rows, the bitmask of h0 > 0 [128][2]
constexpr int K2_A = 0;
constexpr int K2_B = 232;
constexpr int K2_ROWS = K2_B + HID;          // 360
constexpr int K2_MASK_WORDS = HID * K2_BP / 32;
constexpr int K2_SMEM = (K2_ROWS * K2_BP + K2_MASK_WORDS) * 4;  // 91 KB
static_assert(HBR == HID && NSDF + NRGB == HID, "B holds h0, h2 and d h1");
constexpr int R_DEMB = 128;                  // in A, after d h2 (rows 0..127)
constexpr int R_LOG = R_DEMB;                // logits, then d logits (5 rows)
constexpr int R_GRGB = R_LOG + NCLS;         // the rgb cotangent (3 rows)
constexpr int R_DPE = 176;                   // in A (56 rows, 51 used)

__global__ void __launch_bounds__(K2_NT)
    decoder_bwd_point_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             const float* __restrict__ embed, int N,
                             DecoderW dw, const float* __restrict__ wt,
                             float* __restrict__ ws,
                             float* __restrict__ d_x,
                             float* __restrict__ d_embed) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  constexpr int BP = K2_BP, NT = K2_NT;
  const size_t S = N;
  const int n0 = blockIdx.x * BP;
  const int nv = min(BP, N - n0);
  float* A = sm + K2_A * BP;
  float* B = sm + K2_B * BP;
  unsigned* h0_pos = reinterpret_cast<unsigned*>(sm + K2_ROWS * BP);

  // ---- forward recompute (embed is the saved K1 output) ----
  for (int it = threadIdx.x; it < EMB * BP; it += NT) {
    const int e = it / BP, p = it % BP;
    A[(ROW_EMB + e) * BP + p] = p < nv ? embed[e * S + n0 + p] : 0.f;
  }
  tile_pe<BP, NT>(x, N, n0, nv, A + ROW_PE * BP);
  __syncthreads();
  tile_dense<HID, 8, BP, NT, true, false>(A + ROW_PE * BP, PE, dw.w0, HID,
                                          dw.b0, B);                    // h0
  __syncthreads();
  tile_dense<NSDF, 4, BP, NT, false, false>(B, HID, dw.w1, NSDF + NRGB, dw.b1,
                                            A + ROW_SDF_IN * BP);
  tile_dense<NRGB, 4, BP, NT, false, false>(B, HID, dw.w1 + NSDF, NSDF + NRGB,
                                            dw.b1 + NSDF, A + ROW_RGB_IN * BP);
  tile_store<BP, NT>(B, HID, ws + WS_H0 * S, S, n0, nv);
  // h0 > 0 as bits, word (row, 32 points); the lane-staggered order of the
  // reads keeps them free of bank conflicts
  for (int w = threadIdx.x; w < K2_MASK_WORDS; w += NT) {
    const float* row = B + (w / (BP / 32)) * BP + (w % (BP / 32)) * 32;
    unsigned m = 0;
    for (int k = 0; k < 32; ++k) {
      const int b = (k + threadIdx.x) & 31;
      m |= (unsigned)(row[b] > 0.f) << b;
    }
    h0_pos[w] = m;
  }
  __syncthreads();                         // h0 is overwritten below
  tile_dense<HBR, 8, BP, NT, true, false>(A + ROW_SDF_IN * BP, NSDF + EMB,
                                          dw.ws0, HBR, dw.bs0, B);      // h2
  __syncthreads();
  tile_store<BP, NT>(A, ROW_H, ws, S, n0, nv);          // rows 0..226
  tile_store<BP, NT>(B, HBR, ws + WS_H2 * S, S, n0, nv);
  __syncthreads();                         // A is overwritten below

  // ---- head backward (field_pallas.py:460-472) ----
  // logits (rows R_LOG) and g_rgb (rows R_GRGB) as (row, point) items
  for (int it = threadIdx.x; it < (NCLS + 3) * BP; it += NT) {
    const int r = it / BP, p = it % BP;
    if (r < NCLS) {
      float acc = __ldg(dw.bs1 + r);
#pragma unroll 8
      for (int j = 0; j < HBR; ++j)
        acc = fmaf(B[j * BP + p], __ldg(dw.ws1 + j * NCLS + r), acc);
      A[(R_LOG + r) * BP + p] = acc;
    } else {
      A[(R_GRGB + r - NCLS) * BP + p] = p < nv ? g[(r - NCLS) * S + n0 + p] : 0.f;
    }
  }
  __syncthreads();
  // softmax-head backward, one thread per point; d logits replace logits
  if (threadIdx.x < BP) {
    const int p = threadIdx.x;
    const bool ok = p < nv;
    float logits[NCLS], prob[NCLS], gp[NCLS], dot = 0.f;
#pragma unroll
    for (int c = 0; c < NCLS; ++c) logits[c] = A[(R_LOG + c) * BP + p];
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
    for (int c = 0; c < NCLS; ++c) {
      const float dl = prob[c] * (gp[c] - dot);
      A[(R_LOG + c) * BP + p] = dl;
      if (ok) ws[(WS_DLOG + c) * S + n0 + p] = dl;
    }
  }
  __syncthreads();
  // d h2 = (Ws1 d_logits) * (h2 > 0) -> A rows 0..127
  for (int it = threadIdx.x; it < HBR * BP; it += NT) {
    const int j = it / BP, p = it % BP;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < NCLS; ++c)
      acc = fmaf(__ldg(dw.ws1 + j * NCLS + c), A[(R_LOG + c) * BP + p], acc);
    A[j * BP + p] = B[j * BP + p] > 0.f ? acc : 0.f;
  }
  __syncthreads();
  tile_store<BP, NT>(A, HBR, ws + WS_DH2 * S, S, n0, nv);
  // d rgb_in = Wr g_rgb: rows < 64 -> d h1_rgb (B rows 64..127; h2 is no
  // longer read), rows >= 64 -> d pe (A rows R_DPE..)
  for (int it = threadIdx.x; it < (NRGB + PE) * BP; it += NT) {
    const int k = it / BP, p = it % BP;
    const float* wk = dw.wr + k * 3;
    const float v = __ldg(wk) * A[R_GRGB * BP + p] +
                    __ldg(wk + 1) * A[(R_GRGB + 1) * BP + p] +
                    __ldg(wk + 2) * A[(R_GRGB + 2) * BP + p];
    if (k < NRGB)
      B[(NSDF + k) * BP + p] = v;
    else
      A[(R_DPE + k - NRGB) * BP + p] = v;
  }
  __syncthreads();
  // d sdf_in = Ws0 d h2: rows < 64 -> d h1_sdf (B rows 0..63), the rest
  // -> d embed (A rows 128..175)
  tile_dense<NSDF + EMB, 8, BP, NT, false, false>(
      A, HBR, wt + WT_S0, NSDF + EMB, nullptr, B, A + R_DEMB * BP, NSDF);
  __syncthreads();
  tile_store<BP, NT>(A + R_DEMB * BP, EMB, d_embed, S, n0, nv);
  tile_store<BP, NT>(B, NSDF + NRGB, ws + WS_DH1 * S, S, n0, nv);
  // d h0 = (W1 d h1) * (h0 > 0) -> A rows 0..127 (d h2 is stored)
  tile_dense<HID, 8, BP, NT, false, false>(B, NSDF + NRGB, wt + WT_1, HID,
                                           nullptr, A, nullptr, HID, h0_pos);
  __syncthreads();
  tile_store<BP, NT>(A, HID, ws + WS_DH0 * S, S, n0, nv);
  // d pe += W0 d h0 (56 rows, 51 used)
  tile_dense<PE_PAD, 8, BP, NT, false, true>(A, HID, wt + WT_0, PE_PAD,
                                             nullptr, A + R_DPE * BP);
  __syncthreads();
  // d x through the PE: raw-x rows plus the sin/cos chain, (d, point) items
  for (int it = threadIdx.x; it < 3 * BP; it += NT) {
    const int d = it / BP, p = it % BP;
    if (p >= nv) continue;
    const float* dpe = A + R_DPE * BP + p;
    const float xd = x[d * S + n0 + p];
    float acc = dpe[d * BP];
#pragma unroll
    for (int j = 0; j < NFREQ; ++j) {
      const float f = pe_freq(j);
      float sn, cs;
      sincosf(xd * f, &sn, &cs);
      acc += (dpe[(3 + d * 2 * NFREQ + 2 * j) * BP] * cs -
              dpe[(3 + d * 2 * NFREQ + 2 * j + 1) * BP] * sn) * f;
    }
    d_x[d * S + n0 + p] = acc;
  }
}

// ---- (b) weight-gradient reduction over points ----
constexpr int OS_TILE = 64;     // output tile (a rows x d rows)
constexpr int OS_PTS = 16;      // points per shared-memory stage
constexpr int OS_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int N_PAIRS = 5;
constexpr int MAX_TILES = 32;

struct OuterSumArgs {
  const float* a[N_PAIRS];   // [a_rows, N]; row a_rows is an implicit ones row
  const float* d[N_PAIRS];   // [d_rows, N]
  int a_rows[N_PAIRS];
  int d_rows[N_PAIRS];
  int out_off[N_PAIRS];      // offset of the [(a_rows+1), d_rows] block
  int tile_pair[MAX_TILES];
  int tile_k0[MAX_TILES];
  int tile_j0[MAX_TILES];
};

__global__ void __launch_bounds__(OS_THREADS)
    outer_sum_kernel(OuterSumArgs args, int N, int pts_per_split,
                     int total_out, float* __restrict__ partials) {
  __shared__ float As[OS_PTS][OS_TILE + 4];
  __shared__ float Ds[OS_PTS][OS_TILE + 4];
  const int tile = blockIdx.x, split = blockIdx.y;
  const int pr = args.tile_pair[tile];
  const int k0 = args.tile_k0[tile], j0 = args.tile_j0[tile];
  const float* A = args.a[pr];
  const float* D = args.d[pr];
  const int ar = args.a_rows[pr], dr = args.d_rows[pr];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_begin = split * pts_per_split;
  const int n_end = min(N, n_begin + pts_per_split);
  float acc[4][4] = {};

  for (int n0 = n_begin; n0 < n_end; n0 += OS_PTS) {
    // stage A[k0:k0+64][n0:n0+16] and D[j0:j0+64][n0:n0+16]
    for (int i = threadIdx.x; i < OS_TILE * OS_PTS; i += OS_THREADS) {
      int r = i / OS_PTS, p = i % OS_PTS;
      int n = n0 + p, k = k0 + r, j = j0 + r;
      float av = 0.f, dv = 0.f;
      if (n < n_end) {
        if (k < ar) av = A[(size_t)k * N + n];
        else if (k == ar) av = 1.0f;
        if (j < dr) dv = D[(size_t)j * N + n];
      }
      As[p][r] = av;
      Ds[p][r] = dv;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < OS_PTS; ++p) {
      float a[4], d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[p][ty * 4 + i];
        d[i] = Ds[p][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = partials + (size_t)split * total_out + args.out_off[pr];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int k = k0 + ty * 4 + i;
    if (k > ar) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int jj = j0 + tx * 4 + j;
      if (jj < dr) out[k * dr + jj] = acc[i][j];
    }
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

}  // namespace mf

using namespace mf;

static DecoderW make_dw(const float* w0, const float* b0, const float* w1,
                        const float* b1, const float* wr, const float* br,
                        const float* ws0, const float* bs0, const float* ws1,
                        const float* bs1) {
  DecoderW d;
  d.w0 = w0; d.b0 = b0; d.w1 = w1; d.b1 = b1; d.wr = wr; d.br = br;
  d.ws0 = ws0; d.bs0 = bs0; d.ws1 = ws1; d.bs1 = bs1;
  return d;
}

template <bool A, bool B>
static cudaError_t launch_k1(const float* x, int n, const float* s0,
                             const float* s1, const float* cp, DecoderW dw,
                             float* out, float* embed, cudaStream_t st) {
  const int smem = K1_ROWS * K1_BP * (int)sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        field_forward_kernel<A, B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  int grid = (n + K1_BP - 1) / K1_BP;
  field_forward_kernel<A, B><<<grid, K1_NT, smem, st>>>(
      x, n, s0, s1, cp, dw, out, embed);
  return cudaGetLastError();
}

extern "C" int mf_field_forward(const float* x, int n, const float* s0,
                                const float* s1, const float* cp,
                                const float* w0, const float* b0,
                                const float* w1, const float* b1,
                                const float* wr, const float* br,
                                const float* ws0, const float* bs0,
                                const float* ws1, const float* bs1,
                                float* out, float* embed, int sdf_only,
                                void* stream) {
  DecoderW dw = make_dw(w0, b0, w1, b1, wr, br, ws0, bs0, ws1, bs1);
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  if (sdf_only)
    return embed ? (int)launch_k1<true, true>(x, n, s0, s1, cp, dw, out, embed, st)
                 : (int)launch_k1<true, false>(x, n, s0, s1, cp, dw, out, embed, st);
  return embed ? (int)launch_k1<false, true>(x, n, s0, s1, cp, dw, out, embed, st)
               : (int)launch_k1<false, false>(x, n, s0, s1, cp, dw, out, embed, st);
}

extern "C" int mf_decoder_ws_rows() { return WS_ROWS; }
extern "C" int mf_decoder_wt_size() { return WT_SIZE; }

// grads: flat [38625] = per layer (trunk0, trunk1, rgb, sdf0, sdf1) the
// [in+1, out] block of w rows followed by the bias row.
extern "C" int mf_decoder_backward(const float* x, const float* g,
                                   const float* embed, int n,
                                   const float* w0, const float* b0,
                                   const float* w1, const float* b1,
                                   const float* wr, const float* br,
                                   const float* ws0, const float* bs0,
                                   const float* ws1, const float* bs1,
                                   float* wt, float* ws, float* partials,
                                   int splits, float* d_x, float* d_embed,
                                   float* grads, int weight_grads,
                                   void* stream) {
  DecoderW dw = make_dw(w0, b0, w1, b1, wr, br, ws0, bs0, ws1, bs1);
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  transpose_weights_kernel<<<(HID * HID + 255) / 256, 256, 0, st>>>(dw, wt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = K2_SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    e = cudaFuncSetAttribute(decoder_bwd_point_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int grid = (n + K2_BP - 1) / K2_BP;
  decoder_bwd_point_kernel<<<grid, K2_NT, smem, st>>>(x, g, embed, n, dw, wt,
                                                       ws, d_x, d_embed);
  e = cudaGetLastError();
  if (e != cudaSuccess || !weight_grads) return (int)e;

  const size_t S = n;
  OuterSumArgs a;
  // pair order = flat output order: trunk0, trunk1, rgb, sdf0, sdf1
  const float* A[N_PAIRS] = {ws + ROW_PE * S, ws + WS_H0 * S,
                             ws + ROW_RGB_IN * S, ws + ROW_SDF_IN * S,
                             ws + WS_H2 * S};
  const float* D[N_PAIRS] = {ws + WS_DH0 * S, ws + WS_DH1 * S, g,
                             ws + WS_DH2 * S, ws + WS_DLOG * S};
  const int ar[N_PAIRS] = {PE, HID, NRGB + PE, NSDF + EMB, HBR};
  const int dr[N_PAIRS] = {HID, NSDF + NRGB, 3, HBR, NCLS};
  int off = 0, nt = 0;
  for (int p = 0; p < N_PAIRS; ++p) {
    a.a[p] = A[p]; a.d[p] = D[p]; a.a_rows[p] = ar[p]; a.d_rows[p] = dr[p];
    a.out_off[p] = off;
    off += (ar[p] + 1) * dr[p];
    for (int k0 = 0; k0 < ar[p] + 1; k0 += OS_TILE)
      for (int j0 = 0; j0 < dr[p]; j0 += OS_TILE) {
        if (nt >= MAX_TILES) return (int)cudaErrorInvalidValue;
        a.tile_pair[nt] = p; a.tile_k0[nt] = k0; a.tile_j0[nt] = j0; ++nt;
      }
  }
  const int total = off;
  int pts = (n + splits - 1) / splits;
  pts = (pts + OS_PTS - 1) / OS_PTS * OS_PTS;
  dim3 grid_os(nt, splits);
  outer_sum_kernel<<<grid_os, OS_THREADS, 0, st>>>(a, n, pts, total, partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<<<(total + 255) / 256, 256, 0, st>>>(partials, splits,
                                                            total, grads);
  return (int)cudaGetLastError();
}
