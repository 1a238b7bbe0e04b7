// 3xTF32 on the tensor cores (K1 and K2): a float32 operand is split as
// a = hi + lo with hi = rna_tf32(a) and lo = a - hi; a b ~ a_lo b_hi +
// a_hi b_lo + a_hi b_hi, summed in float32 by mma.sync.m16n8k8 (the dropped
// a_lo b_lo is ~2^-22 of a b), which keeps float32 accuracy where single
// TF32 (10 mantissa bits) keeps about three digits.

#pragma once
#include <stdint.h>

namespace mf {

// TF32 round to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds
// (add half of the 13 dropped bits to the magnitude, then drop them; two
// integer instructions)
__device__ __forceinline__ uint32_t tf32_rna(float f) {
  return (__float_as_uint(f) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo exactly in float32; the tensor core reads lo's top 19 bits
// (its truncation costs ~2^-21 of a)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

}  // namespace mf
