// GCN neighbourhood aggregation, out = A_hat (n, n) @ X (n, f) over a
// dense normalised adjacency, skipping source tiles that hold no edge,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gcn_agg.py::_gcn_kernel (the Pallas kernel
// that gcn_aggregate_pallas launches at :89), the paper's irregular
// gather-sum.
//
// Bound on the H100: the op reads the dense A_hat once (its occupancy
// pass must), X once and writes the output once, about 2 FLOPs per edge
// and feature against n^2 + 2 n f elements, so bytes bound it:
// (n^2 + 2 n f) sizeof(T) / 3.35 TB/s.
//
// Design: a node's output row is one warp's work, lanes over features:
// lane l of a feature tile of 32 FPL columns (FPL a template parameter,
// 1..16) holds the accumulators of columns f0 + l + 32 i, so every X row
// read and every store coalesces.  A CTA's 8 warps own block_n = 8 lws
// consecutive rows (lws rows per warp from the mapping policy; warp w
// takes rows w, w + 8, ...), which is the node block of the occupancy
// mask occ (node blocks x source tiles of block_s columns): a tile whose
// occ entry is 0 is skipped, as the JAX kernel skips it.  In an occupied
// tile the warp reads its A row 32 columns at a time (coalesced), finds
// the non-zeros with a ballot and, for each one in ascending column
// order, broadcasts the weight with a shuffle and gathers that row of X
// (from L2: X is shared by every node block), so the work is the
// graph's edges, not the dense tile.  Nothing is staged in shared
// memory; the feature width is tiled by the register budget over
// gridDim.y.  Bounds are checked: no padded copy of A or X.  f32
// accumulation, output rounded once to X's dtype.  Inputs fp32 or bf16.

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

template <typename T, int FPL>
__global__ void __launch_bounds__(kThreads)
gcn_kernel(const int* __restrict__ occ, const T* __restrict__ a,
           const T* __restrict__ x, T* __restrict__ out, int n, int f,
           int lws, int block_s, int tiles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f0 = blockIdx.y * 32 * FPL;
  const int* occ_row = occ + (long long)blockIdx.x * tiles;
  const long long row0 = (long long)blockIdx.x * kWarps * lws + warp;
  for (int j = 0; j < lws; ++j) {
    const long long row = row0 + (long long)kWarps * j;
    if (row >= n) break;  // uniform across the warp
    float acc[FPL];
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] = 0.f;
    const T* arow = a + row * n;
    for (int s = 0; s < tiles; ++s) {
      if (occ_row[s] == 0) continue;  // an empty tile: skipped
      const int s0 = s * block_s;
      const int s1 = min(s0 + block_s, n);
      for (int c0 = s0; c0 < s1; c0 += 32) {
        const int col = c0 + lane;
        const float av = col < s1 ? to_f32(arow[col]) : 0.f;
        unsigned nz = __ballot_sync(0xffffffffu, av != 0.f);
        while (nz) {
          const int k = __ffs(nz) - 1;
          nz &= nz - 1;
          const float w = __shfl_sync(0xffffffffu, av, k);
          const T* xr = x + (long long)(c0 + k) * f;
#pragma unroll
          for (int i = 0; i < FPL; ++i) {
            const int fi = f0 + lane + 32 * i;
            if (fi < f) acc[i] = fmaf(w, to_f32(xr[fi]), acc[i]);
          }
        }
      }
    }
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

// occ: int32 (ceil(n / (8 lws)), tiles) with tiles = ceil(n / block_s).
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int gcn_agg(const void* occ, const void* a, const void* x,
                       void* out, int n, int f, int lws, int grid_n,
                       int grid_f, int block_s, int fpl, int dtype,
                       void* stream) {
  void* fn = kernel_for(dtype, fpl);
  if (fn == nullptr || n < 1 || f < 1 || lws < 1 || block_s < 1 ||
      (long long)grid_n * kWarps * lws < n ||
      (long long)grid_f * 32 * fpl < f || grid_f > 65535)
    return (int)cudaErrorInvalidValue;
  int tiles = (n + block_s - 1) / block_s;
  void* args[] = {(void*)&occ, (void*)&a, (void*)&x, &out, &n, &f,
                  &lws, &block_s, &tiles};
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
