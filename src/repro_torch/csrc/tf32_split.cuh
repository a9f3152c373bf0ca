// The TF32 split of a float32 operand for 3xTF32 products on Hopper's
// tensor cores (sm_90a), shared by csrc/matmul_tf32x3.cu and
// csrc/nn_search.cu (csrc/ssd.cu takes tf32_rna alone for its big halves):
// x = big + small, big = x rounded to TF32
// (cvt.rna.tf32.f32, ties away from zero), small = the TF32 rounding of
// x - big.  kernels/matmul.py::tf32_split_plain is its plain version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32_split {

// x rounded to TF32, nearest with ties away from zero; the 13 low bits
// cleared, so the value is exact in f32 and x - big is exact too
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// big and small of x.  A finite x whose rounding would overflow to
// infinity (within half a TF32 step of FLT_MAX) is cut toward zero
// instead, so a finite operand stays finite.  An infinity is its own big
// part and a NaN the quiet NaN 0x7fffe000; their small part is 0, not
// x - big (inf - inf, a NaN).
__device__ __forceinline__ void split_store(float x, float* big,
                                            float* small) {
  float hi = tf32_rna(x), lo = 0.f;
  if (isfinite(x)) {
    if (!isfinite(hi)) hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
    lo = tf32_rna(x - hi);
  } else {
    hi = isnan(x) ? __uint_as_float(0x7fffe000u) : x;
  }
  *big = hi;
  *small = lo;
}

}  // namespace tf32_split
