// vecadd, out = x + y over a 1-D vector, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vecadd.py::_vecadd_kernel (the Pallas
// kernel that vecadd_pallas launches at :43), the paper's Fig. 1 kernel.
//
// Bound on the H100: one add per 3 elements moved (two read, one
// written), far below the ~20 FLOP/byte the CUDA cores need to be the
// limit, so bytes bound it: 3 n * sizeof(T) / 3.35 TB/s.  Once n is
// large the only lever is to keep enough loads in flight; below hp
// elements the launch itself (a few microseconds) dominates.
//
// Design: the mapping decides the counts, the kernel does what it is
// told.  grid CTAs of 256 threads; thread t of the T = grid * 256
// launched takes the lws items t, t + T, t + 2T, ... (bounds-checked: no
// padded copy), so each warp's 32 loads are consecutive addresses and
// coalesce into full transactions, whatever lws the policy chose.  (The
// paper's Vortex mapping walks a contiguous chunk of lws items per
// thread, which on a GPU strides a warp's loads by lws.)  Inputs fp32 or
// bf16; the add is done in fp32 and rounded once, which for two bf16
// operands is the correctly rounded bf16 sum.

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
vecadd_kernel(const T* __restrict__ x, const T* __restrict__ y,
              T* __restrict__ out, long long n, int lws) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
#pragma unroll 4
  for (int j = 0; j < lws; ++j, i += stride) {
    if (i >= n) break;
    store(out + i, __fadd_rn(to_f32(x[i]), to_f32(y[i])));
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, long long n, int lws,
           int grid, cudaStream_t stream) {
  vecadd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(out), n, lws);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int vecadd(const void* x, const void* y, void* out, long long n,
                      int lws, int grid, int dtype, void* stream) {
  if (n < 1 || lws < 1 || grid < 1 || (long long)grid * kThreads * lws < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, out, n, lws, grid, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, out, n, lws, grid, st);
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM that the CUDA runtime reports for this kernel.
extern "C" int vecadd_occupancy(int dtype, int* blocks) {
  if (dtype == 0)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, vecadd_kernel<float>, kThreads, 0);
  if (dtype == 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, vecadd_kernel<__nv_bfloat16>, kThreads, 0);
  return (int)cudaErrorInvalidValue;
}
