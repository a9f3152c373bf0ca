// saxpy, out = a * x + y over a 1-D vector, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/saxpy.py::_saxpy_kernel (the Pallas kernel
// that saxpy_pallas launches at :39).  The scalar a is rounded to x's
// dtype first, as saxpy_pallas does (saxpy.py:38); the wrapper passes it
// already rounded.
//
// Bound on the H100: two FLOPs per 3 elements moved, so bytes bound it:
// 3 n * sizeof(T) / 3.35 TB/s (as vecadd.cu).
//
// Design: vecadd.cu's mapping (grid CTAs of 256 threads, lws items per
// thread at stride T = grid * 256, coalesced, bounds-checked).  The
// product and the sum are done in fp32 with __fmul_rn / __fadd_rn, so
// no fused multiply-add contracts them: the kernel rounds exactly where
// its plain PyTorch version does (the product to fp32, the sum to fp32,
// then once to bf16 for bf16 inputs).  The JAX kernel does the bf16
// case in bf16 arithmetic, rounding the product too; the two agree to
// within one bf16 ulp of |a x| + |y|.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
saxpy_kernel(float a, const T* __restrict__ x, const T* __restrict__ y,
             T* __restrict__ out, long long n, int lws) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
#pragma unroll 4
  for (int j = 0; j < lws; ++j, i += stride) {
    if (i >= n) break;
    store(out + i, __fadd_rn(__fmul_rn(a, to_f32(x[i])), to_f32(y[i])));
  }
}

template <typename T>
int launch(float a, const void* x, const void* y, void* out, long long n,
           int lws, int grid, cudaStream_t stream) {
  saxpy_kernel<T><<<grid, kThreads, 0, stream>>>(
      a, static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(out), n, lws);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int saxpy(float a, const void* x, const void* y, void* out,
                     long long n, int lws, int grid, int dtype,
                     void* stream) {
  if (n < 1 || lws < 1 || grid < 1 || (long long)grid * kThreads * lws < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, x, y, out, n, lws, grid, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, x, y, out, n, lws, grid, st);
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM that the CUDA runtime reports for this kernel.
extern "C" int saxpy_occupancy(int dtype, int* blocks) {
  if (dtype == 0)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, saxpy_kernel<float>, kThreads, 0);
  if (dtype == 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, saxpy_kernel<__nv_bfloat16>, kThreads, 0);
  return (int)cudaErrorInvalidValue;
}
