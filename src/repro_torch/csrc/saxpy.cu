// saxpy, out = a * x + y over a 1-D vector, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/saxpy.py::_saxpy_kernel (the Pallas kernel
// that saxpy_pallas launches at :39).  The scalar a is rounded to x's
// dtype first, as saxpy_pallas does (saxpy.py:38); the wrapper passes it
// already rounded.
//
// Bound on the H100: bytes, 3 n * sizeof(T) / 3.35 TB/s (two FLOPs per
// 3 elements moved).  Design: csrc/vector_map.cuh's map, as vecadd.cu
// (16-byte vectors, four loads a batch before the arithmetic, where lws
// >= v and the pointers lie on 16 bytes; the n mod v tail one element a
// thread; scalars otherwise).  The product and the sum are done in fp32
// with __fmul_rn / __fadd_rn, so no fused multiply-add contracts them:
// the kernel rounds exactly where its plain PyTorch version does (the
// product to fp32, the sum to fp32, then once to bf16 for bf16 inputs)
// and gives its bits.  The JAX kernel does the bf16 case in bf16
// arithmetic, rounding the product too; the two agree to within one bf16
// ulp of |a x| + |y|.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vector_map.cuh"

namespace {

struct Axpy {
  float a;
  __device__ __forceinline__ float operator()(float x, float y) const {
    return __fadd_rn(__fmul_rn(a, x), y);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  steps > 0: the vector kernel, steps
// 16-byte vectors a thread (x, y and out on 16 bytes); 0: the scalar
// kernel, lws elements a thread.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int saxpy(float a, const void* x, const void* y, void* out,
                     long long n, int lws, int grid, int steps, int dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector_map::launch<float>(Axpy{a}, x, y, out, n, lws, grid,
                                     steps, st);
  if (dtype == 1)
    return vector_map::launch<__nv_bfloat16>(Axpy{a}, x, y, out, n, lws,
                                             grid, steps, st);
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM that the CUDA runtime reports for the vector
// (vector != 0) or the scalar kernel.
extern "C" int saxpy_occupancy(int dtype, int vector, int* blocks) {
  if (dtype == 0) return vector_map::occupancy<float, Axpy>(vector, blocks);
  if (dtype == 1)
    return vector_map::occupancy<__nv_bfloat16, Axpy>(vector, blocks);
  return (int)cudaErrorInvalidValue;
}
