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
// thread; scalars otherwise).  The kernel rounds where the JAX kernel's
// arithmetic in x's dtype rounds: the product with __fmul_rn, rounded to
// bf16 and widened again for bf16 inputs, then the sum with __fadd_rn
// rounded to x's dtype, so no fused multiply-add contracts them.  Its
// plain PyTorch version rounds at the same places and gives its bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vector_map.cuh"

namespace {

// a x + y for elements of T: the product rounded to T before the add
template <typename T>
struct Axpy {
  float a;
  __device__ __forceinline__ float operator()(float x, float y) const {
    return __fadd_rn(__fmul_rn(a, x), y);
  }
};

template <>
struct Axpy<__nv_bfloat16> {
  float a;
  __device__ __forceinline__ float operator()(float x, float y) const {
    return __fadd_rn(__bfloat162float(__float2bfloat16(__fmul_rn(a, x))), y);
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
    return vector_map::launch<float>(Axpy<float>{a}, x, y, out, n, lws,
                                     grid, steps, st);
  if (dtype == 1)
    return vector_map::launch<__nv_bfloat16>(Axpy<__nv_bfloat16>{a}, x, y,
                                             out, n, lws, grid, steps, st);
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM that the CUDA runtime reports for the vector
// (vector != 0) or the scalar kernel.
extern "C" int saxpy_occupancy(int dtype, int vector, int* blocks) {
  if (dtype == 0)
    return vector_map::occupancy<float, Axpy<float>>(vector, blocks);
  if (dtype == 1)
    return vector_map::occupancy<__nv_bfloat16, Axpy<__nv_bfloat16>>(
        vector, blocks);
  return (int)cudaErrorInvalidValue;
}
