// An elementwise map out = op(x, y) over 1-D vectors for Hopper (sm_90a),
// shared by csrc/vecadd.cu (op: x + y) and csrc/saxpy.cu (op: a x + y).
// The op takes and returns f32 (bf16 operands widened, the result rounded
// once to the vectors' type); it is a template parameter, so each
// kernel's code is what it would be written out by hand.
//
// Bound on the H100: one or two operations per 3 elements moved (two
// read, one written), far below the ~20 FLOP/byte the CUDA cores need to
// be the limit, so bytes bound it: 3 n * sizeof(T) / 3.35 TB/s.  Once n
// is large the only lever is to keep enough bytes in flight; below hp
// elements the launch itself (a few microseconds) dominates.
//
// Design: the mapping decides the counts, the kernel does what it is
// told.  grid CTAs of 256 threads, T = grid * 256 threads in all; a
// thread takes lws items at stride T (bounds-checked: no padded copy),
// so a warp's 32 accesses are consecutive addresses and coalesce,
// whatever lws the policy chose.  (The paper's Vortex mapping walks a
// contiguous chunk of lws items per thread, which on a GPU strides a
// warp's loads by lws.)  The items come in one of two widths:
//  * vectors (vector_kernel), when lws is at least a vector and x, y and
//    out start on 16 bytes: an item is a 16-byte vector, 4 f32 or 8 bf16;
//    thread t takes vectors t, t + T, t + 2T, ... for `steps` =
//    ceil(lws / v) steps, in batches of kBatch whose loads are all
//    issued, predicated and without a branch out of the loop, before the
//    first op, so a thread keeps 2 kBatch 16-byte loads in flight.  The
//    n mod v elements past the last whole vector go one to a thread, to
//    threads 0 ... n mod v - 1.
//  * scalars (scalar_kernel), otherwise (NAIVE's lws = 1, the paper's
//    one item a thread; or a pointer off 16 bytes): items t, t + T, ...
// Both widths apply the same op to the same elements: they give the
// same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vector_map {

constexpr int kThreads = 256;
constexpr int kBatch = 4;        // vectors a thread loads before the ops

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// op of two 16-byte vectors of T, element by element
template <typename T, typename Op>
__device__ __forceinline__ uint4 map16(const Op& op, uint4 a, uint4 b) {
  constexpr int kV = 16 / sizeof(T);
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
  uint4 r;
  T* o = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int e = 0; e < kV; ++e) store(o + e, op(to_f32(x[e]), to_f32(y[e])));
  return r;
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
scalar_kernel(Op op, const T* __restrict__ x, const T* __restrict__ y,
              T* __restrict__ out, long long n, int lws) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
#pragma unroll 4
  for (int j = 0; j < lws; ++j, i += stride) {
    if (i >= n) break;
    store(out + i, op(to_f32(x[i]), to_f32(y[i])));
  }
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
vector_kernel(Op op, const T* __restrict__ x, const T* __restrict__ y,
              T* __restrict__ out, long long n, int steps) {
  constexpr int kV = 16 / sizeof(T);
  const long long nv = n / kV;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (int j0 = 0; j0 < steps; j0 += kBatch) {
    uint4 a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = t + (j0 + u) * stride;
      if (j0 + u < steps && i < nv) {
        a[u] = __ldg(xv + i);
        b[u] = __ldg(yv + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = t + (j0 + u) * stride;
      if (j0 + u < steps && i < nv) ov[i] = map16<T>(op, a[u], b[u]);
    }
  }
  const long long e = nv * kV + t;         // the tail: n mod v elements
  if (e < n) store(out + e, op(to_f32(x[e]), to_f32(y[e])));
}

// steps > 0: the vector kernel, steps 16-byte vectors a thread (x, y and
// out on 16 bytes); 0: the scalar kernel, lws elements a thread.
// Returns cudaGetLastError() after the launch (0 on success).
template <typename T, typename Op>
int launch(const Op& op, const void* x, const void* y, void* out,
           long long n, int lws, int grid, int steps, cudaStream_t stream) {
  if (n < 1 || lws < 1 || grid < 1 || steps < 0 ||
      (long long)grid * kThreads * lws < n)
    return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  if (steps > 0) {
    constexpr int kV = 16 / sizeof(T);
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
         reinterpret_cast<uintptr_t>(out)) % 16 ||
        (long long)grid * kThreads * steps * kV < n)
      return (int)cudaErrorInvalidValue;
    vector_kernel<T><<<grid, kThreads, 0, stream>>>(op, xt, yt, ot, n,
                                                     steps);
  } else {
    scalar_kernel<T><<<grid, kThreads, 0, stream>>>(op, xt, yt, ot, n, lws);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs per SM that the CUDA runtime reports for the vector
// (vector != 0) or the scalar kernel.
template <typename T, typename Op>
int occupancy(int vector, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, vector ? vector_kernel<T, Op> : scalar_kernel<T, Op>,
      kThreads, 0);
}

}  // namespace vector_map
