// K1: fused field forward (embed + PE + decoder + softmax head).
//
// K1 replaces mipsfusion_tpu/ops/field_pallas.py field_query_pallas
// (_make_field_kernel): x [3, N] -> out [10, N] (rgb 3, sdf, entropy,
// prob 5), or [1, N] sdf only, plus the embed [48, N] on request.
//
// What bounds it on this card: a point needs 38,233 MACs (29,696 sdf only)
// against ~0.25 KB of I/O, so it is bound by arithmetic: the decoder's
// matrix products at float32 accuracy, which on the tensor cores take three
// TF32 products each (tf32.cuh). What it reaches is the rate at which an
// SM takes mma.sync instructions (measured: about one m16n8k8 every 2.3
// cycles an SM, seven tenths of the kernel's time), then the integer
// instructions that split each weight (two tenths).
//
// Design. A warp owns 16 points from the gathers to the stores and keeps
// every activation in registers: the accumulator fragment of one
// mma.sync.m16n8k8 layer (thread (g, t) holds features 8j+2t, 8j+2t+1 of
// points g and g+8) is the A fragment of the next layer's k-block j once
// that layer's weight rows are permuted to match, and the permutation is
// free because the weights are packed for it. So no activation goes
// through shared memory and there is no barrier between layers.
//  * pack_weights_kernel (once per call) writes every layer's weights in
//    mma B-fragment order ([k-block][pair of 8-column tiles][lane][4], so a
//    lane's B fragments of two tiles are one 16-byte load), rows permuted
//    as above, widths padded with zeros (PE 51 -> 56, 5 logits and 3 rgb ->
//    8 columns), biases behind them: 40,272 floats.
//  * One persistent block per SM stages the packed set in shared memory
//    once (161 KB; hi and lo parts of every weight would not fit, so a
//    weight is split when it is used) and its warps walk the 16-point
//    tiles with no block-wide barrier after that.
//  * Within a k-block the products of four column tiles are sent term by
//    term (lo-hi x4, hi-lo x4, hi-hi x4), so neighbouring tensor-core
//    instructions never wait on each other; the narrow head layers (5
//    logits, 3 rgb, one column tile) run four k-blocks into four
//    accumulators for the same reason and add them in a fixed order.
//  * The four lanes of a quad share a point pair: each computes 6 of the 24
//    sin/cos pairs and 3 of the 12 embed parts (2 plane scales, 10 groups
//    of 4 CP channels) of each point, exactly the values its A fragments
//    hold, and the softmax head is a few quad shuffles.
// The summation order is fixed, so a call gives the same bits every time.
// Precision: float32 storage, 3xTF32 products with float32 accumulation.

#include "common.cuh"
#include "tf32.cuh"

namespace mf {

constexpr int K1_NT = 384;                   // 168 registers a thread
constexpr int K1_WARPS = K1_NT / 32;
constexpr int K1_BP = 16;                    // points of a warp's tile
constexpr int PE_KB = 7;                     // k-blocks of 8: PE 51 -> 56
constexpr int EMB_KB = EMB / 8;              // 6
constexpr int HID_KB = HID / 8;              // 16
constexpr int H1_KB = NSDF / 8;              // 8 (sdf half; the rgb half too)
constexpr int HBR_KB = HBR / 8;              // 16
static_assert(NSDF == NRGB && HID == 128 && HBR == 128, "flagship widths");

// The packed set, in floats. A wide layer (128 columns = 8 tile pairs):
// [k-block][pair][lane][4]; a narrow one (8 columns): [k-block][lane][2].
constexpr int WIDE_KB = 8 * 32 * 4;          // floats per k-block
constexpr int NARROW_KB = 32 * 2;
constexpr int PK_W0 = 0;
constexpr int PK_W1 = PK_W0 + PE_KB * WIDE_KB;
constexpr int PK_WS0 = PK_W1 + HID_KB * WIDE_KB;
constexpr int PK_WS1 = PK_WS0 + (H1_KB + EMB_KB) * WIDE_KB;
constexpr int PK_WR = PK_WS1 + HBR_KB * NARROW_KB;
constexpr int PK_B0 = PK_WR + (H1_KB + PE_KB) * NARROW_KB;
constexpr int PK_B1 = PK_B0 + HID;
constexpr int PK_BS0 = PK_B1 + NSDF + NRGB;
constexpr int PK_BS1 = PK_BS0 + HBR;         // 5 + 3 zeros
constexpr int PK_BR = PK_BS1 + 8;            // 3 + 5 zeros
constexpr int PK_SIZE = PK_BR + 8;
static_assert(PK_SIZE == 40272 && PK_SIZE % 4 == 0, "packed size");
constexpr int K1_SMEM = PK_SIZE * 4;         // 161,088 B: one block per SM

// Which logical input row sits in slot s (0..7) of k-block kb.
// After a layer: the accumulator of column tile kb holds columns 2t, 2t+1
// in thread t, which become A slots t and t+4.
__host__ __device__ __forceinline__ int perm_chain(int kb, int s) {
  return 8 * kb + 2 * (s & 3) + (s >> 2);
}
// PE rows [x 3 | per (axis, band) sin, cos]: thread t of k-block kb < 6
// holds the sin (slot t) and cos (slot t+4) of pair 4 kb + t; k-block 6
// holds raw x in slots 0..2 and zeros (-1).
__host__ __device__ __forceinline__ int perm_pe(int kb, int s) {
  if (kb < 6) return 3 + 2 * (4 * kb + (s & 3)) + (s >> 2);
  return s < 3 ? s : -1;
}
// Embed rows: thread t holds parts t, t+4, t+8 (4 rows each); part t + 4i
// fills k-blocks 2i (rows 0, 1 of the part) and 2i+1 (rows 2, 3).
__host__ __device__ __forceinline__ int perm_emb(int kb, int s) {
  return 4 * ((s & 3) + 4 * (kb >> 1)) + 2 * (kb & 1) + (s >> 2);
}

__global__ void pack_weights_kernel(DecoderW dw, float* __restrict__ packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PK_SIZE) return;
  float v = 0.f;
  if (i < PK_WS1) {                          // trunk0, trunk1, sdf0
    const int layer = i < PK_W1 ? 0 : i < PK_WS0 ? 1 : 2;
    const int r = i - (layer == 0 ? PK_W0 : layer == 1 ? PK_W1 : PK_WS0);
    const int e = r & 3, lane = (r >> 2) & 31, np = (r >> 7) & 7;
    const int kb = r / WIDE_KB;
    const int slot = (lane & 3) + 4 * (e & 1);
    const int n = 8 * (2 * np + (e >> 1)) + (lane >> 2);
    const int k = layer == 0 ? perm_pe(kb, slot)
                  : layer == 1 ? perm_chain(kb, slot)
                  : kb < H1_KB ? perm_chain(kb, slot)
                               : NSDF + perm_emb(kb - H1_KB, slot);
    const float* W = layer == 0 ? dw.w0 : layer == 1 ? dw.w1 : dw.ws0;
    if (k >= 0) v = W[k * 128 + n];
  } else if (i < PK_B0) {                    // sdf1 (5 columns), rgb (3)
    const bool rgb = i >= PK_WR;
    const int r = i - (rgb ? PK_WR : PK_WS1);
    const int e = r & 1, lane = (r >> 1) & 31, kb = r / NARROW_KB;
    const int slot = (lane & 3) + 4 * e, n = lane >> 2;
    int k = (!rgb || kb < H1_KB) ? perm_chain(kb, slot)
                                 : perm_pe(kb - H1_KB, slot);
    if (rgb && kb >= H1_KB && k >= 0) k += NRGB;
    const int nv = rgb ? 3 : NCLS;
    if (k >= 0 && n < nv) v = (rgb ? dw.wr : dw.ws1)[k * nv + n];
  } else {                                   // biases
    const int r = i - PK_B0;
    if (r < PK_B1 - PK_B0) v = dw.b0[r];
    else if (i < PK_BS0) v = dw.b1[i - PK_B1];
    else if (i < PK_BS1) v = dw.bs0[i - PK_BS0];
    else if (i < PK_BR) v = i - PK_BS1 < NCLS ? dw.bs1[i - PK_BS1] : 0.f;
    else v = i - PK_BR < 3 ? dw.br[i - PK_BR] : 0.f;
  }
  packed[i] = v;
}

__device__ __forceinline__ void mma_frag(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
}

// c[j] += A B for NT8 column tiles (a multiple of 4) of a wide layer:
// a[kb] are the warp's A fragments, Wp the packed weights of k-block 0 at
// the first tile pair used (float4 units).
template <int KB, int NT8>
__device__ __forceinline__ void layer_wide(const float (&a)[KB][4],
                                           const float4* Wp, int lane,
                                           float (&c)[NT8][4]) {
  constexpr int G = 4;                       // column tiles per group
  static_assert(NT8 % G == 0, "column tiles in groups");
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    uint32_t ah[4], al[4];
    split4(a[kb], ah, al);
#pragma unroll
    for (int n0 = 0; n0 < NT8; n0 += G) {
      uint32_t bh[2 * G], bl[2 * G];
#pragma unroll
      for (int i = 0; i < G / 2; ++i) {
        const float4 w = Wp[(kb * 8 + n0 / 2 + i) * 32 + lane];
        split_tf32(w.x, bh[4 * i], bl[4 * i]);
        split_tf32(w.y, bh[4 * i + 1], bl[4 * i + 1]);
        split_tf32(w.z, bh[4 * i + 2], bl[4 * i + 2]);
        split_tf32(w.w, bh[4 * i + 3], bl[4 * i + 3]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
        mma_frag(c[n0 + j], al, bh[2 * j], bh[2 * j + 1]);
#pragma unroll
      for (int j = 0; j < G; ++j)
        mma_frag(c[n0 + j], ah, bl[2 * j], bl[2 * j + 1]);
#pragma unroll
      for (int j = 0; j < G; ++j)
        mma_frag(c[n0 + j], ah, bh[2 * j], bh[2 * j + 1]);
    }
  }
}

// c[kb % 4] += A[kb] B[kb] for the one column tile of a narrow layer (Wp
// in float2 units at k-block 0).
template <int KB>
__device__ __forceinline__ void layer_narrow(const float (&a)[KB][4],
                                             const float2* Wp, int lane,
                                             float (&c)[4][4]) {
#pragma unroll
  for (int k4 = 0; k4 < KB; k4 += 4) {
    uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k4 + j < KB) {
        split4(a[k4 + j], ah[j], al[j]);
        const float2 w = Wp[(k4 + j) * 32 + lane];
        split_tf32(w.x, bh[j][0], bl[j][0]);
        split_tf32(w.y, bh[j][1], bl[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k4 + j < KB) mma_frag(c[j], al[j], bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k4 + j < KB) mma_frag(c[j], ah[j], bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k4 + j < KB) mma_frag(c[j], ah[j], bh[j][0], bh[j][1]);
  }
}

// The accumulators start at the bias of their two columns.
template <int NT8>
__device__ __forceinline__ void bias_init(const float* b, int t,
                                          float (&c)[NT8][4]) {
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    const float2 v = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
    c[j][0] = v.x; c[j][1] = v.y; c[j][2] = v.x; c[j][3] = v.y;
  }
}

// Accumulator fragments -> the next layer's A fragments (perm_chain).
template <int NT8, bool RELU>
__device__ __forceinline__ void frag_c_to_a(const float (&c)[NT8][4],
                                            float (&a)[NT8][4]) {
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    a[j][0] = RELU ? fmaxf(c[j][0], 0.f) : c[j][0];
    a[j][1] = RELU ? fmaxf(c[j][2], 0.f) : c[j][2];
    a[j][2] = RELU ? fmaxf(c[j][1], 0.f) : c[j][1];
    a[j][3] = RELU ? fmaxf(c[j][3], 0.f) : c[j][3];
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// The softmax head of one point across its quad: thread t holds logits
// 2t and 2t+1 (classes >= 5 are padding). Returns this thread's two
// probabilities, the sdf and the entropy (the same bits in all four lanes).
__device__ __forceinline__ void quad_head(float l0, float l1, int t,
                                          float& p0, float& p1, float& sdf,
                                          float& ent) {
  const bool v0 = 2 * t < NCLS, v1 = 2 * t + 1 < NCLS;
  const float ninf = __int_as_float(0xff800000);
  const float m = quad_max(fmaxf(v0 ? l0 : ninf, v1 ? l1 : ninf));
  const float e0 = v0 ? expf(l0 - m) : 0.f, e1 = v1 ? expf(l1 - m) : 0.f;
  const float s = quad_sum(e0 + e1);
  p0 = e0 / s;
  p1 = e1 / s;
  const float w = quad_sum(p0 * (float)(2 * t) + p1 * (float)(2 * t + 1));
  sdf = (w / (float)(NCLS - 1) - 0.5f) * 2.0f;
  ent = quad_sum(-(v0 ? p0 * log2f(p0 + 1e-5f) : 0.f) -
                 (v1 ? p1 * log2f(p1 + 1e-5f) : 0.f));
}

template <bool SDF_ONLY, bool RET_EMBED>
__global__ void __launch_bounds__(K1_NT, 1)
    field_forward_kernel(const float* __restrict__ x, int N,
                         const float* __restrict__ s0,
                         const float* __restrict__ s1,
                         const float* __restrict__ cp,
                         const float4* __restrict__ packed,
                         float* __restrict__ out, float* __restrict__ embed) {
  extern __shared__ float4 sm4[];
  for (int i = threadIdx.x; i < PK_SIZE / 4; i += K1_NT) sm4[i] = packed[i];
  __syncthreads();                           // the only block-wide barrier
  const float* W = reinterpret_cast<const float*>(sm4);
  const float2* W2 = reinterpret_cast<const float2*>(sm4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t S = N;
  const int n_tiles = (N + K1_BP - 1) / K1_BP;
  for (int tile = blockIdx.x * K1_WARPS + warp; tile < n_tiles;
       tile += gridDim.x * K1_WARPS) {
    // this thread's two points: columns g and g + 8 of the tile
    const int n[2] = {tile * K1_BP + g, tile * K1_BP + g + 8};
    const bool ok[2] = {n[0] < N, n[1] < N};
    float xp[2][3];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int d = 0; d < 3; ++d) xp[q][d] = ok[q] ? x[d * S + n[q]] : 0.5f;

    // ---- PE: A fragments [point g slot t, g+8 t, g t+4, g+8 t+4] ----
    float pe[PE_KB][4];
#pragma unroll
    for (int kb = 0; kb < 6; ++kb) {
      const float f = pe_freq(4 * (kb & 1) + t);      // pair 4 kb + t
#pragma unroll
      for (int q = 0; q < 2; ++q)
        sincosf(xp[q][kb >> 1] * f, &pe[kb][q], &pe[kb][2 + q]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      pe[6][q] = t == 0 ? xp[q][0] : t == 1 ? xp[q][1] : t == 2 ? xp[q][2]
                                                                : 0.f;
      pe[6][2 + q] = 0.f;
    }

    // ---- rgb, the PE rows of its input (its h1 rows follow below) ----
    float crgb[4][4];
    if (!SDF_ONLY) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        crgb[j][0] = crgb[j][1] = crgb[j][2] = crgb[j][3] = 0.f;
      layer_narrow<PE_KB>(pe, W2 + (PK_WR + H1_KB * NARROW_KB) / 2, lane,
                          crgb);
    }

    // ---- trunk0: h0 = relu(pe W0 + b0) ----
    float a0[HID_KB][4];
    {
      float h0[HID_KB][4];
      bias_init<HID_KB>(W + PK_B0, t, h0);
      layer_wide<PE_KB, HID_KB>(pe, sm4 + PK_W0 / 4, lane, h0);
      frag_c_to_a<HID_KB, true>(h0, a0);
    }

    // ---- trunk1, rgb half, and the rgb layer ----
    float rgb[4];
    if (!SDF_ONLY) {
      float h1r[H1_KB][4], ar[H1_KB][4];
      bias_init<H1_KB>(W + PK_B1 + NSDF, t, h1r);
      layer_wide<HID_KB, H1_KB>(a0, sm4 + PK_W1 / 4 + 4 * 32, lane, h1r);
      frag_c_to_a<H1_KB, false>(h1r, ar);
      layer_narrow<H1_KB>(ar, W2 + PK_WR / 2, lane, crgb);
      const float2 br = *reinterpret_cast<const float2*>(W + PK_BR + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rgb[i] = ((crgb[0][i] + crgb[1][i]) + (crgb[2][i] + crgb[3][i])) +
                 ((i & 1) ? br.y : br.x);
    }

    // ---- trunk1, sdf half ----
    float as[H1_KB][4];
    {
      float h1s[H1_KB][4];
      bias_init<H1_KB>(W + PK_B1, t, h1s);
      layer_wide<HID_KB, H1_KB>(a0, sm4 + PK_W1 / 4, lane, h1s);
      frag_c_to_a<H1_KB, false>(h1s, as);
    }

    // ---- embed: parts t, t+4, t+8 of both points ----
    float em[EMB_KB][4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int part = t + 4 * i;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float4 v;
        if (i == 0 && t < 2)
          v = t == 0 ? scale_lookup<R0>(s0, xp[q])
                     : scale_lookup<R1>(s1, xp[q]);
        else
          v = cp_lookup4(cp, xp[q], 4 * (part - 2));
        em[2 * i][q] = v.x;
        em[2 * i][2 + q] = v.y;
        em[2 * i + 1][q] = v.z;
        em[2 * i + 1][2 + q] = v.w;
        if (RET_EMBED && ok[q]) {
          float* e = embed + (size_t)(4 * part) * S + n[q];
          e[0] = v.x; e[S] = v.y; e[2 * S] = v.z; e[3 * S] = v.w;
        }
      }
    }

    // ---- sdf0: h2 = relu([h1 sdf | embed] Ws0 + bs0) ----
    float a2[HBR_KB][4];
    {
      float h2[HBR_KB][4];
      bias_init<HBR_KB>(W + PK_BS0, t, h2);
      layer_wide<H1_KB, HBR_KB>(as, sm4 + PK_WS0 / 4, lane, h2);
      layer_wide<EMB_KB, HBR_KB>(em, sm4 + (PK_WS0 + H1_KB * WIDE_KB) / 4,
                                 lane, h2);
      frag_c_to_a<HBR_KB, true>(h2, a2);
    }

    // ---- sdf1: logits, then the softmax head over the quad ----
    float cl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cl[j][0] = cl[j][1] = cl[j][2] = cl[j][3] = 0.f;
    layer_narrow<HBR_KB>(a2, W2 + PK_WS1 / 2, lane, cl);
    const float2 bs1 = *reinterpret_cast<const float2*>(W + PK_BS1 + 2 * t);
    float lg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lg[i] = ((cl[0][i] + cl[1][i]) + (cl[2][i] + cl[3][i])) +
              ((i & 1) ? bs1.y : bs1.x);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float p0, p1, sdf, ent;
      quad_head(lg[2 * q], lg[2 * q + 1], t, p0, p1, sdf, ent);
      if (!ok[q]) continue;                  // no shuffles below
      float* o = out + n[q];
      if (SDF_ONLY) {
        if (t == 0) o[0] = sdf;
        continue;
      }
      if (t == 0) {
        o[0] = rgb[2 * q];
        o[S] = rgb[2 * q + 1];
      } else if (t == 1) {
        o[2 * S] = rgb[2 * q];
      } else if (t == 2) {
        o[3 * S] = sdf;
      } else {
        o[4 * S] = ent;
      }
      if (2 * t < NCLS) o[(size_t)(5 + 2 * t) * S] = p0;
      if (2 * t + 1 < NCLS) o[(size_t)(6 + 2 * t) * S] = p1;
    }
  }
}

}  // namespace mf

using namespace mf;

template <bool SDF_ONLY, bool RET_EMBED>
static cudaError_t launch_k1(const float* x, int n, const float* s0,
                             const float* s1, const float* cp,
                             const float* packed, float* out, float* embed,
                             int sms, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        field_forward_kernel<SDF_ONLY, RET_EMBED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, K1_SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_tiles = (n + K1_BP - 1) / K1_BP;
  const int need = (n_tiles + K1_WARPS - 1) / K1_WARPS;
  const int grid = need < sms ? need : sms;
  field_forward_kernel<SDF_ONLY, RET_EMBED><<<grid, K1_NT, K1_SMEM, st>>>(
      x, n, s0, s1, cp, reinterpret_cast<const float4*>(packed), out, embed);
  return cudaGetLastError();
}

extern "C" int mf_field_packed_size() { return PK_SIZE; }

// The decoder's weights in K1's packed order (the first step of
// mf_field_forward, on its own).
extern "C" int mf_field_pack_weights(const float* w0, const float* b0,
                                     const float* w1, const float* b1,
                                     const float* wr, const float* br,
                                     const float* ws0, const float* bs0,
                                     const float* ws1, const float* bs1,
                                     float* packed, void* stream) {
  DecoderW dw = make_dw(w0, b0, w1, b1, wr, br, ws0, bs0, ws1, bs1);
  pack_weights_kernel<<<(PK_SIZE + 255) / 256, 256, 0,
                        (cudaStream_t)stream>>>(dw, packed);
  return (int)cudaGetLastError();
}

// packed: scratch of mf_field_packed_size() floats; sms: the device's SM
// count (the persistent grid has at most one block per SM).
extern "C" int mf_field_forward(const float* x, int n, const float* s0,
                                const float* s1, const float* cp,
                                const float* w0, const float* b0,
                                const float* w1, const float* b1,
                                const float* wr, const float* br,
                                const float* ws0, const float* bs0,
                                const float* ws1, const float* bs1,
                                float* packed, int sms, float* out,
                                float* embed, int sdf_only, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  int e = mf_field_pack_weights(w0, b0, w1, b1, wr, br, ws0, bs0, ws1, bs1,
                                packed, stream);
  if (e != (int)cudaSuccess) return e;
  if (sdf_only) {
    // no caller wants the embed beside the sdf alone: no such instance
    if (embed) return (int)cudaErrorInvalidValue;
    return (int)launch_k1<true, false>(x, n, s0, s1, cp, packed, out, embed,
                                       sms, st);
  }
  return embed ? (int)launch_k1<false, true>(x, n, s0, s1, cp, packed, out,
                                             embed, sms, st)
               : (int)launch_k1<false, false>(x, n, s0, s1, cp, packed, out,
                                              embed, sms, st);
}
