// RMSNorm, out = x * rsqrt(mean(x^2) + eps) * gamma over (tokens, d)
// rows, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::_rmsnorm_kernel (the Pallas
// kernel that rmsnorm_pallas launches at :56).
//
// Bound on the H100: ~4 FLOPs per element against 2 elements moved (x
// read once, out written once; gamma is d elements), so bytes bound it:
// (2 tokens d + d) * sizeof(T) / 3.35 TB/s.  Reaching it takes x read
// from HBM exactly once and ~20 KB of loads in flight on every SM
// (3.35 TB/s x ~0.8 us over 132 SMs).
//
// Design: a row reduction is one warp's work.  A CTA of 8 warps owns
// 8 * lws consecutive rows; warp w takes rows w, w + 8, ..., w + 8 (lws
// - 1) of them (lws = rows per warp, from the mapping policy), so the 8
// warps of a CTA read neighbouring rows at the same time.  Sums of
// squares are f32, completed by a butterfly of warp shuffles; the output
// is x * r * gamma in f32, rounded once to x's dtype.  Two paths, picked
// by the wrapper (kernels/rmsnorm.py::row_path) and checked here:
//  * vector: x, gamma and out 16-byte aligned, d * sizeof(T) a multiple
//    of 16, and 9 rows' worth (8 rows and gamma) within the block's
//    opt-in shared memory.  Each warp stages its row in shared memory
//    with 16-byte cp.async copies, lane l copying vectors l, l + 32, ...
//    (one warp instruction moves 512 bytes); a lane reads back only its
//    own vectors, so it waits on its own copies and no barrier is needed.
//    x is read from device memory once: the sum of squares and the scale
//    read the staged row.  The first row's copies are issued before
//    gamma is staged (once a CTA, reused over its 8 lws rows), and the
//    next row's copy into a vector slot as soon as the slot has been
//    scaled and stored, so each warp keeps its next row in flight while
//    it finishes the current one.  9 d sizeof(T) bytes of shared memory:
//    at bf16 d = 4096, 72 KB, 3 CTAs a SM; at smollm's d = 576, 10 KB.
//    (Rows held in registers instead, 1 to 16 vectors a lane, were timed
//    beside this path on an H100: no faster beyond the run-to-run spread
//    at (8, 576), slower at bf16 d = 4096; PERF.md, row 7.)
//  * scalar: the rest (a pointer off a 16-byte boundary, d * sizeof(T)
//    not a multiple of 16, a row too long to stage).  Lane l takes
//    columns l, l + 32, ... one scalar at a time and the second pass
//    reads the row again from L1/L2.
// Inputs fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "smem_optin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Path { kScalar = 0, kVector = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// a 16-byte vector as 4 f32 or 8 bf16 values
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// a bf16 is the high half of an f32: widening is a shift
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack2(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ static void unpack(const uint4& u, float* f) {
    unpack2(u.x, f);
    unpack2(u.y, f + 2);
    unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& u) {
  float f[Vec<T>::N], s = 0.f;
  Vec<T>::unpack(u, f);
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) s += f[e] * f[e];
  return s;
}

// x * r * gamma, rounded to T
template <typename T>
__device__ __forceinline__ uint4 scale(const uint4& u, const uint4& g,
                                       float r) {
  float f[Vec<T>::N], gf[Vec<T>::N];
  Vec<T>::unpack(u, f);
  Vec<T>::unpack(g, gf);
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) f[e] = f[e] * r * gf[e];
  return Vec<T>::pack(f);
}

// gamma's nv vectors into shared memory, once a CTA
__device__ __forceinline__ void stage_gamma(uint4* g_s, const void* gamma,
                                            int nv) {
  const uint4* g = static_cast<const uint4*>(gamma);
  for (int i = threadIdx.x; i < nv; i += kThreads) g_s[i] = __ldg(g + i);
  __syncthreads();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vector_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      T* __restrict__ out, int tokens, int d, int lws,
                      float eps) {
  extern __shared__ uint4 smem[];
  const int nv = d / Vec<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  long long row = (long long)blockIdx.x * kWarps * lws + warp;
  uint4* x_s = smem + nv + (size_t)warp * nv;
  const bool live = row < tokens;
  if (live) {                              // in flight while gamma stages
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    for (int c = lane; c < nv; c += 32) cp_async16(x_s + c, xr + c);
  }
  stage_gamma(smem, gamma, nv);
  if (!live) return;                       // no barrier follows
  for (int j = 0;; ++j, row += kWarps) {
    cp_async_wait_all();                   // this lane's own slots
    float ss = 0.f;
    for (int c = lane; c < nv; c += 32) ss += sum_squares<T>(x_s[c]);
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
    const bool more = j + 1 < lws && row + kWarps < tokens;
    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
    const uint4* xn = reinterpret_cast<const uint4*>(
        x + (more ? row + kWarps : row) * d);
    for (int c = lane; c < nv; c += 32) {
      __stcs(orow + c, scale<T>(x_s[c], smem[c], r));
      if (more) cp_async16(x_s + c, xn + c);
    }
    if (!more) break;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_scalar_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      T* __restrict__ out, int tokens, int d, int lws,
                      float eps) {
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
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
    T* orow = out + row * d;
    for (int c = lane; c < d; c += 32)
      store(orow + c, to_f32(xr[c]) * r * to_f32(gamma[c]));
  }
}

size_t smem_bytes(int path, int d, size_t size) {
  return path == kVector ? (size_t)(kWarps + 1) * d * size : 0;
}

template <typename T>
const void* kernel_for(int path) {
  if (path == kScalar) return (const void*)rmsnorm_scalar_kernel<T>;
  if (path == kVector) return (const void*)rmsnorm_vector_kernel<T>;
  return nullptr;
}

// the vector kernel of T with its shared-memory limit raised, once
template <typename T>
cudaError_t allow_smem() {
  static std::atomic<unsigned> devices{0};
  return smem_optin::allow((const void*)rmsnorm_vector_kernel<T>, devices);
}

template <typename T>
int launch(const void* x, const void* gamma, void* out, int tokens, int d,
           int lws, int grid, float eps, int path, cudaStream_t stream) {
  const void* fn = kernel_for<T>(path);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(path, d, sizeof(T));
  if (path == kVector) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(gamma) |
                           reinterpret_cast<uintptr_t>(out);
    if (ptrs % 16 || (d * sizeof(T)) % 16) return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem<T>();
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&x, &gamma, &out, &tokens, &d, &lws, &eps};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem,
                               stream);
}

template <typename T>
int occupancy(int d, int path, int* blocks) {
  const void* fn = kernel_for<T>(path);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (path == kVector) {
    cudaError_t err = allow_smem<T>();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kThreads, smem_bytes(path, d, sizeof(T)));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  path: 0 scalar, 1 vector (16-byte
// aligned pointers, d * sizeof(T) a multiple of 16, 9 d sizeof(T) bytes
// of shared memory).  Returns the launch's error (0 on success); a path
// the pointers, d or the shared memory do not allow is refused.
extern "C" int rmsnorm(const void* x, const void* gamma, void* out,
                       int tokens, int d, int lws, int grid, float eps,
                       int dtype, int path, void* stream) {
  if (tokens < 1 || d < 1 || lws < 1 || grid < 1 ||
      (long long)grid * kWarps * lws < tokens)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, out, tokens, d, lws, grid, eps, path, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, out, tokens, d, lws, grid, eps,
                                 path, st);
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM that the CUDA runtime reports for the kernel of
// (dtype, path) at row length d.
extern "C" int rmsnorm_occupancy(int d, int dtype, int path, int* blocks) {
  if (dtype == 0) return occupancy<float>(d, path, blocks);
  if (dtype == 1) return occupancy<__nv_bfloat16>(d, path, blocks);
  return (int)cudaErrorInvalidValue;
}
