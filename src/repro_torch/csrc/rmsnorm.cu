// RMSNorm, out = x * rsqrt(mean(x^2) + eps) * gamma over (tokens, d)
// rows, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::_rmsnorm_kernel (the Pallas
// kernel that rmsnorm_pallas launches at :56).
//
// Bound on the H100: ~4 FLOPs per element against 2 elements moved (x
// read once, out written once; gamma is d elements), so bytes bound it:
// (2 tokens d + d) * sizeof(T) / 3.35 TB/s.
//
// Design: a row reduction is one warp's work.  A CTA of 8 warps owns
// 8 * lws consecutive rows; warp w takes rows w, w + 8, ..., w + 8 (lws
// - 1) of them (lws = rows per warp, from the mapping policy), so the 8
// warps of a CTA read neighbouring rows at the same time.  Each lane
// sums x^2 over the columns lane, lane + 32, ... in fp32; a butterfly of
// warp shuffles completes the sum; the second pass reads the row again
// (from L1/L2, a row is at most a few KB), scales and rounds once to
// x's dtype.  Nothing is staged in shared memory.  Inputs fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
               T* __restrict__ out, int tokens, int d, int lws, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row0 = (long long)blockIdx.x * kWarps * lws + warp;
  for (int j = 0; j < lws; ++j) {
    const long long row = row0 + (long long)kWarps * j;
    if (row >= tokens) break;                  // uniform across the warp
    const T* xr = x + row * d;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = to_f32(xr[c]);
      ss += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / (float)d + eps);
    T* orow = out + row * d;
    for (int c = lane; c < d; c += 32)
      store(orow + c, to_f32(xr[c]) * r * to_f32(gamma[c]));
  }
}

template <typename T>
int launch(const void* x, const void* gamma, void* out, int tokens, int d,
           int lws, int grid, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<T*>(out), tokens, d, lws, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int rmsnorm(const void* x, const void* gamma, void* out,
                       int tokens, int d, int lws, int grid, float eps,
                       int dtype, void* stream) {
  if (tokens < 1 || d < 1 || lws < 1 || grid < 1 ||
      (long long)grid * kWarps * lws < tokens)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, out, tokens, d, lws, grid, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, out, tokens, d, lws, grid, eps,
                                 st);
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM that the CUDA runtime reports for this kernel.
extern "C" int rmsnorm_occupancy(int dtype, int* blocks) {
  if (dtype == 0)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, rmsnorm_kernel<float>, kThreads, 0);
  if (dtype == 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, rmsnorm_kernel<__nv_bfloat16>, kThreads, 0);
  return (int)cudaErrorInvalidValue;
}
