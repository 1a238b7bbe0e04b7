// Shared definitions of the field kernels (shapes, taps, encode).
//
// The kernels are templates over a compile-time field shape (FieldShape:
// NS plane scales of F = 4 features, a CP term of RCP lines x CCP
// channels). shape.cu is compiled once per shape of the table in
// ops/_build.py, with that shape's -D flags; it instantiates every
// kernel for it and defines the C entry points with the shape's name as
// suffix. What no config changes stays fixed: 8-band PE (51 inputs with
// raw xyz), decoder 128 / 64+64 / 128 / 5 classes. The Python wrappers
// raise on any shape outside the table; the plain PyTorch versions take
// any.
//
// Layouts are the plain parameter layouts of mipsfusion_tpu_torch (the
// same as the JAX tree): plane s [3, R, R, 4], CP [3, RCP, CCP], decoder
// w [in, out] row-major, b [out]. Point-indexed arrays are points-minor:
// x [3, N], embed [E, N], out [10, N].
//
// Precision: float32 storage and float32 accuracy throughout (K1's and K2's
// tensor-core products split each operand into two TF32 parts, tf32.cuh).

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace mf {

constexpr int FEAT = 4;
constexpr int NFREQ = 8;
constexpr int PE = 3 + 3 * NFREQ * 2;     // 51
constexpr int HID = 128;                  // trunk hidden
constexpr int NSDF = 64;
constexpr int NRGB = 64;
constexpr int HBR = 128;                  // sdf branch hidden
constexpr int NCLS = 5;
constexpr int OUT_ROWS = 5 + NCLS;        // rgb 3, sdf, entropy, prob 5

// A field shape: NS = 2 or 3 plane scales of resolutions R0, R1 (, R2),
// and CP lines of RCP rows x CCP channels. The embed is [scale 0 | ..
// | CP], E = NS * 4 + CCP rows, read in "parts" of 4 rows: one per scale,
// then one per group of 4 CP channels.
template <int NS_, int R0_, int R1_, int R2_, int RCP_, int CCP_>
struct FieldShape {
  static constexpr int NS = NS_;
  static constexpr int R0 = R0_, R1 = R1_, R2 = R2_;
  static constexpr int RCP = RCP_, CCP = CCP_;
  static constexpr int NCPG = CCP / 4;              // CP groups of 4
  static constexpr int EMB = NS * FEAT + CCP;       // embed rows E
  static constexpr int EMB_PAD = (EMB + 7) / 8 * 8; // E padded to 8
  static constexpr int NPART = NS + NCPG;           // 4-row parts
  static constexpr int PLANES = 3 * FEAT * (R0 * R0 + R1 * R1
                                            + (NS > 2 ? R2 * R2 : 0));
  static constexpr int CP_SIZE = 3 * RCP * CCP;
  static_assert(NS == 2 || NS == 3, "2 or 3 plane scales");
  static_assert(CCP % 4 == 0 && NCPG <= 10, "CP groups of 4, at most 10");
  static_assert(NS == 3 || R2 == 0, "R2 is unused with 2 scales");
};

// A kernel's raised dynamic shared-memory limit (cudaFuncSetAttribute) is
// a property of the current device: a launch on another device needs it
// set there too. `set` runs once per device ordinal; `done` is the
// caller's static table of devices already set.
constexpr int MAX_DEVICES = 64;

template <class Set>
cudaError_t once_per_device(bool (&done)[MAX_DEVICES], Set set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  if ((e = set()) != cudaSuccess) return e;
  done[dev] = true;
  return cudaSuccess;
}

// The pointers of one field's encoding tables (s[2] null with 2 scales).
struct Planes {
  const float* s[3];
  const float* cp;
};

struct Tap {
  int i0, i1;      // lower row and upper row (upper clamped to R-1)
  float w;         // weight of the upper row (1-w on the lower)
  bool has_next;   // row i0+1 exists
};

// Reference _coords (triplane_pallas.py:157): clip(u*(R-1), 0, R-1-1e-6)
// in float32. The bound is formed in double and rounded once, as numpy
// does; for R = 64, 128, 384 and 512 it rounds to exactly R-1, so i0 can be
// R-1 and the upper tap (weight 0) must not read row R.
template <int R>
__device__ __forceinline__ Tap make_tap(float u) {
  const float hi = (float)((double)(R - 1) - 1e-6);
  float p = fminf(fmaxf(u * (float)(R - 1), 0.0f), hi);
  float f = floorf(p);
  Tap t;
  t.i0 = (int)f;
  t.w = p - f;
  t.has_next = t.i0 + 1 <= R - 1;
  t.i1 = t.has_next ? t.i0 + 1 : R - 1;
  return t;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// How a lookup reads its 16-byte taps: from device memory through the
// read-only path (the default; what K1 does), or from a table that K0 has
// staged in shared memory. The arithmetic around the loads is the same
// code for both, so the two give the same bits.
struct GlobalLd {
  __device__ __forceinline__ float4 operator()(const float* p) const {
    return ld4(p);
  }
};
struct SharedLd {
  __device__ __forceinline__ float4 operator()(const float* p) const {
    return *reinterpret_cast<const float4*>(p);
  }
};

__device__ __forceinline__ float4 f4_axpy(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// Bilinear lookup of the 4 features of one [R, R, 4] plane.
template <int R, class Ld = GlobalLd>
__device__ __forceinline__ float4 plane_lookup(const float* P, const Tap& u,
                                               const Tap& v, Ld ld = {}) {
  float4 p00 = ld(P + (u.i0 * R + v.i0) * FEAT);
  float4 p01 = ld(P + (u.i0 * R + v.i1) * FEAT);
  float4 p10 = ld(P + (u.i1 * R + v.i0) * FEAT);
  float4 p11 = ld(P + (u.i1 * R + v.i1) * FEAT);
  float a = (1.0f - u.w) * (1.0f - v.w), b = (1.0f - u.w) * v.w;
  float c = u.w * (1.0f - v.w), d = u.w * v.w;
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  r = f4_axpy(a, p00, r);
  r = f4_axpy(b, p01, r);
  r = f4_axpy(c, p10, r);
  r = f4_axpy(d, p11, r);
  return r;
}

// Sum of the three plane lookups of one scale (planes xy, xz, yz).
template <int R, class Ld = GlobalLd>
__device__ __forceinline__ float4 scale_lookup(const float* S, const float x[3],
                                               Ld ld = {}) {
  Tap t[3] = {make_tap<R>(x[0]), make_tap<R>(x[1]), make_tap<R>(x[2])};
  const int RR = R * R * FEAT;
  float4 a = plane_lookup<R>(S, t[0], t[1], ld);
  float4 b = plane_lookup<R>(S + RR, t[0], t[2], ld);
  float4 c = plane_lookup<R>(S + 2 * RR, t[1], t[2], ld);
  return make_float4(a.x + b.x + c.x, a.y + b.y + c.y, a.z + b.z + c.z,
                     a.w + b.w + c.w);
}

// Product of the three CP line lookups for channels c..c+3.
template <class Sh, class Ld = GlobalLd>
__device__ __forceinline__ float4 cp_lookup4(const float* cp, const float x[3],
                                             int c, Ld ld = {}) {
  constexpr int RCP = Sh::RCP, CCP = Sh::CCP;
  float4 prod = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const Tap t = make_tap<RCP>(x[a]);
    const float* L = cp + (size_t)a * RCP * CCP;
    float4 lo = ld(L + t.i0 * CCP + c);
    float4 hi = ld(L + t.i1 * CCP + c);
    prod.x *= (1.0f - t.w) * lo.x + t.w * hi.x;
    prod.y *= (1.0f - t.w) * lo.y + t.w * hi.y;
    prod.z *= (1.0f - t.w) * lo.z + t.w * hi.z;
    prod.w *= (1.0f - t.w) * lo.w + t.w * hi.w;
  }
  return prod;
}

// Part `part` of a point's embed (4 rows): a scale's three plane lookups
// for part < NS, then CP group part - NS; zeros past the last part.
template <class Sh>
__device__ __forceinline__ float4 embed_part(const Planes& P, const float x[3],
                                             int part) {
  if (part == 0) return scale_lookup<Sh::R0>(P.s[0], x);
  if (part == 1) return scale_lookup<Sh::R1>(P.s[1], x);
  if constexpr (Sh::NS > 2) {
    if (part == 2) return scale_lookup<Sh::R2>(P.s[2], x);
  }
  if (part < Sh::NPART) return cp_lookup4<Sh>(P.cp, x, 4 * (part - Sh::NS));
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// PE frequency 2^j * pi in float32 (reference: float32(2^j) * float32(pi)).
__device__ __forceinline__ float pe_freq(int j) {
  return (float)(1 << j) * 3.14159265358979323846f;
}

// Softmax head: prob, sdf = (sum p_i i / (C-1) - 0.5) * 2.
__device__ __forceinline__ float softmax_head(const float logits[NCLS],
                                             float prob[NCLS]) {
  float m = logits[0];
#pragma unroll
  for (int c = 1; c < NCLS; ++c) m = fmaxf(m, logits[c]);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NCLS; ++c) {
    prob[c] = expf(logits[c] - m);
    s += prob[c];
  }
  float sdf = 0.f;
#pragma unroll
  for (int c = 0; c < NCLS; ++c) {
    prob[c] = prob[c] / s;
    sdf += prob[c] * (float)c;
  }
  return (sdf / (float)(NCLS - 1) - 0.5f) * 2.0f;
}

struct DecoderW {
  const float *w0, *b0, *w1, *b1, *wr, *br, *ws0, *bs0, *ws1, *bs1;
};

static inline DecoderW make_dw(const float* w0, const float* b0,
                               const float* w1, const float* b1,
                               const float* wr, const float* br,
                               const float* ws0, const float* bs0,
                               const float* ws1, const float* bs1) {
  DecoderW d;
  d.w0 = w0; d.b0 = b0; d.w1 = w1; d.b1 = b1; d.wr = wr; d.br = br;
  d.ws0 = ws0; d.bs0 = bs0; d.ws1 = ws1; d.bs1 = bs1;
  return d;
}

}  // namespace mf

// The decoder's parameters as the C entry points take them: w, b per layer
// (trunk0, trunk1, rgb, sdf0, sdf1).
#define MF_DECODER_ARGS                                                       \
  const float *w0, const float *b0, const float *w1, const float *b1,        \
      const float *wr, const float *br, const float *ws0, const float *bs0,  \
      const float *ws1, const float *bs1
