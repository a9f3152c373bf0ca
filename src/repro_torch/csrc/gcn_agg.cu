// GCN neighbourhood aggregation, out = A_hat (n, n) @ X (n, f) over a
// dense normalised adjacency, in one pass over A_hat, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gcn_agg.py::_gcn_kernel (the Pallas kernel
// that gcn_aggregate_pallas launches at :89), the paper's irregular
// gather-sum.
//
// Bound on the H100: the op reads the dense A_hat once, X once and writes
// the output once, about 2 FLOPs per edge and feature against n^2 + 2 n f
// elements, so bytes bound it: (n^2 + 2 n f) sizeof(T) / 3.35 TB/s.
//
// Design: a node's output row is one warp's work, lanes over features:
// lane l of a feature tile of 32 FPL columns (FPL a template parameter,
// 1..16) holds the accumulators of columns f0 + l + 32 i, so every X row
// read and every store coalesces.  A CTA's 8 warps own 8 lws consecutive
// rows (lws rows per warp from the mapping policy; warp w takes rows w,
// w + 8, ...).  The warp streams its A row once (once per feature tile)
// with streaming loads, so A does not evict X from L2: a scalar head up
// to the row's first 16-byte boundary (rows of n elements start off 16
// bytes unless n sizeof(T) is a multiple of 16), then 16-byte vectors (4
// f32 or 8 bf16 a lane) in batches of kBatch a lane, the next batch's
// loads issued before the current one is inspected (two batches in
// flight, also over the gathers), then a scalar tail.  It finds the
// non-zeros with a ballot
// and, for each lane holding one in lane order and within a lane in
// element order (so in ascending column order), broadcasts the weights
// with shuffles and gathers that row of X (from L2: X is shared by every
// row), so the work is the graph's edges, not the dense row.  The TPU
// kernel's tile-occupancy mask, which skips the MXU work of an empty
// tile, has no counterpart: the ballot already skips every zero, and the
// mask cost a second pass over A.  A NaN weight is non-zero and reaches
// its row's sums, as in the plain version (the JAX wrapper skips a tile
// whose sum |a| is NaN).  Nothing is staged in shared memory; the feature
// width is tiled by the register budget over gridDim.y.  Bounds are
// checked: no padded copy of A or X.  f32 accumulation (fmaf in ascending
// column order), output rounded once to X's dtype.  Inputs fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;            // 16-byte loads a lane issues at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// acc += w * X[col, f0 + lane + 32 i]
template <typename T, int FPL>
__device__ __forceinline__ void gather(float (&acc)[FPL], float w,
                                       const T* __restrict__ x, long long col,
                                       int f, int f0, int lane) {
  const T* xr = x + col * f;
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int fi = f0 + lane + 32 * i;
    if (fi < f) acc[i] = fmaf(w, to_f32(xr[fi]), acc[i]);
  }
}

// The columns [c0, c0 + len) of the row, len <= 32, one a lane.
template <typename T, int FPL>
__device__ __forceinline__ void scalar_run(float (&acc)[FPL],
                                           const T* __restrict__ arow,
                                           const T* __restrict__ x, int c0,
                                           int len, int f, int f0, int lane) {
  const float av = lane < len ? to_f32(arow[c0 + lane]) : 0.f;
  unsigned nz = __ballot_sync(0xffffffffu, av != 0.f);
  while (nz) {
    const int k = __ffs(nz) - 1;
    nz &= nz - 1;
    const float w = __shfl_sync(0xffffffffu, av, k);
    gather<T, FPL>(acc, w, x, c0 + k, f, f0, lane);
  }
}

template <typename T>
__device__ __forceinline__ bool any_nonzero(const uint4& v) {
  constexpr int kV = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&v);
  bool nz = false;
#pragma unroll
  for (int i = 0; i < kV; ++i) nz |= to_f32(e[i]) != 0.f;
  return nz;
}

template <typename T, int FPL>
__global__ void __launch_bounds__(kThreads)
gcn_kernel(const T* __restrict__ a, const T* __restrict__ x,
           T* __restrict__ out, int n, int f, int lws) {
  constexpr int kV = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f0 = blockIdx.y * 32 * FPL;
  const long long row0 = (long long)blockIdx.x * kWarps * lws + warp;
  for (int j = 0; j < lws; ++j) {
    const long long row = row0 + (long long)kWarps * j;
    if (row >= n) break;  // uniform across the warp
    float acc[FPL];
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] = 0.f;
    const T* arow = a + row * n;
    // head: up to the first 16-byte boundary; vectors; tail
    const int off = (int)(reinterpret_cast<uintptr_t>(arow) % 16) /
                    (int)sizeof(T);
    const int head = min(n, off ? kV - off : 0);
    const int nv = (n - head) / kV;
    scalar_run<T, FPL>(acc, arow, x, 0, head, f, f0, lane);
    const uint4* av = reinterpret_cast<const uint4*>(arow + head);
    uint4 cur[kBatch], nxt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = 32 * u + lane;
      cur[u] = v < nv ? __ldcs(av + v) : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int v0 = 0; v0 < nv; v0 += 32 * kBatch) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = v0 + 32 * (kBatch + u) + lane;
        nxt[u] = v < nv ? __ldcs(av + v) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        unsigned nz = __ballot_sync(0xffffffffu, any_nonzero<T>(cur[u]));
        while (nz) {
          const int k = __ffs(nz) - 1;
          nz &= nz - 1;
          uint4 wv;
          wv.x = __shfl_sync(0xffffffffu, cur[u].x, k);
          wv.y = __shfl_sync(0xffffffffu, cur[u].y, k);
          wv.z = __shfl_sync(0xffffffffu, cur[u].z, k);
          wv.w = __shfl_sync(0xffffffffu, cur[u].w, k);
          const T* we = reinterpret_cast<const T*>(&wv);
          const long long col = head + (long long)(v0 + 32 * u + k) * kV;
#pragma unroll
          for (int e = 0; e < kV; ++e) {
            const float w = to_f32(we[e]);
            if (w != 0.f) gather<T, FPL>(acc, w, x, col + e, f, f0, lane);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
    }
    const int tail0 = head + nv * kV;
    scalar_run<T, FPL>(acc, arow, x, tail0, n - tail0, f, f0, lane);
    T* orow = out + row * f;
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int fi = f0 + lane + 32 * i;
      if (fi < f) store(orow + fi, acc[i]);
    }
  }
}

template <typename T>
void* kernel_of(int fpl) {
  switch (fpl) {
    case 1: return (void*)gcn_kernel<T, 1>;
    case 2: return (void*)gcn_kernel<T, 2>;
    case 4: return (void*)gcn_kernel<T, 4>;
    case 8: return (void*)gcn_kernel<T, 8>;
    case 16: return (void*)gcn_kernel<T, 16>;
  }
  return nullptr;
}

void* kernel_for(int dtype, int fpl) {
  if (dtype == 0) return kernel_of<float>(fpl);
  if (dtype == 1) return kernel_of<__nv_bfloat16>(fpl);
  return nullptr;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; a and x start on their element size.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gcn_agg(const void* a, const void* x, void* out, int n, int f,
                       int lws, int grid_n, int grid_f, int fpl, int dtype,
                       void* stream) {
  void* fn = kernel_for(dtype, fpl);
  if (fn == nullptr || n < 1 || f < 1 || lws < 1 ||
      (long long)grid_n * kWarps * lws < n ||
      (long long)grid_f * 32 * fpl < f || grid_f > 65535)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&a, (void*)&x, &out, &n, &f, &lws};
  cudaError_t err =
      cudaLaunchKernel(fn, dim3(grid_n, grid_f), dim3(kThreads), args, 0,
                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM that the CUDA runtime reports for the plan's
// instantiation (its accumulators' registers).
extern "C" int gcn_occupancy(int fpl, int dtype, int* blocks) {
  void* fn = kernel_for(dtype, fpl);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kThreads, 0);
}
