// Separable Gaussian blur, two passes over an (h, w) image, for Hopper
// (sm_90a): a row pass along the width, then a column pass along the
// height, each with zero ("same") padding at the image's edges.
//
// Replaces: src/repro/kernels/stencil.py::_row_pass_kernel (the Pallas
// kernel that gaussian_blur_pallas launches at :98) and
// ::_col_pass_kernel (:106), the paper's "atypical" stencil.
//
// Bound on the H100: 2 ksize FLOPs per pixel and pass against 2 pixels
// moved (read once, written once), so bytes bound each pass:
// 2 h w sizeof(T) / 3.35 TB/s, and the blur is the sum of the two.
//
// Design: the mapping decides the counts.  A CTA of 256 threads covers
// lws rows x 256 columns, one column per thread and lws pixels down it
// (lws from the mapping policy); a warp's 32 threads take 32 consecutive
// columns, so every load and store coalesces.  The grid is 1-D: CTA b
// takes row block b / column_tiles and column tile b % column_tiles.
// Each pass stages its input tile in shared memory as f32 with its halo
// (halo = (ksize - 1) / 2): the row pass the 2 halo extra columns, the
// column pass the 2 halo extra rows, zero where they fall off the image,
// so no padded copy is made and no neighbouring block is read twice by
// a thread.  A larger lws re-reads a smaller share of halo rows in the
// column pass (2 halo / lws), which is the reuse the paper's stencil
// shows.  Taps are computed on the host in f32 and passed by value.  The
// sum runs over the taps in order, acc = acc + tap * x with each
// operation rounded (no fused multiply-add), which is what the plain
// version computes; each pass rounds once to the image's dtype, as the
// JAX row pass writes an img.dtype intermediate.  Inputs fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // = the tile's width: one column per thread
constexpr int kMaxTaps = 64;

struct Taps {
  float c[kMaxTaps];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Thread 0 copies the taps to shared memory with static indices, so the
// parameter struct is never indexed at run time.
__device__ __forceinline__ void load_taps(const Taps& taps, float* dst) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) dst[i] = taps.c[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_pass_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w,
                int lws, int ksize, Taps taps) {
  extern __shared__ float tile[];  // lws x (256 + 2 halo)
  __shared__ float coef[kMaxTaps];
  load_taps(taps, coef);
  const int halo = (ksize - 1) / 2;
  const int pitch = kThreads + 2 * halo;
  const int col_tiles = (w + kThreads - 1) / kThreads;
  const long long row0 = (long long)(blockIdx.x / col_tiles) * lws;
  const int col0 = (blockIdx.x % col_tiles) * kThreads;
  for (int e = threadIdx.x; e < lws * pitch; e += kThreads) {
    const long long gr = row0 + e / pitch;
    const int gc = col0 + e % pitch - halo;
    tile[e] = (gr < h && gc >= 0 && gc < w) ? to_f32(x[gr * w + gc]) : 0.f;
  }
  __syncthreads();
  const int gc = col0 + threadIdx.x;
  if (gc >= w) return;
  for (int j = 0; j < lws; ++j) {
    const long long gr = row0 + j;
    if (gr >= h) break;
    const float* s = tile + j * pitch + threadIdx.x;
    float acc = 0.f;
    for (int t = 0; t < ksize; ++t)
      acc = __fadd_rn(acc, __fmul_rn(coef[t], s[t]));
    store(out + gr * w + gc, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
col_pass_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w,
                int lws, int ksize, Taps taps) {
  extern __shared__ float tile[];  // (lws + 2 halo) x 256
  __shared__ float coef[kMaxTaps];
  load_taps(taps, coef);
  const int halo = (ksize - 1) / 2;
  const int col_tiles = (w + kThreads - 1) / kThreads;
  const long long row0 = (long long)(blockIdx.x / col_tiles) * lws;
  const int col0 = (blockIdx.x % col_tiles) * kThreads;
  const int gc = col0 + threadIdx.x;
  for (int r = 0; r < lws + 2 * halo; ++r) {
    const long long gr = row0 + r - halo;
    tile[r * kThreads + threadIdx.x] =
        (gr >= 0 && gr < h && gc < w) ? to_f32(x[gr * w + gc]) : 0.f;
  }
  __syncthreads();
  if (gc >= w) return;
  for (int j = 0; j < lws; ++j) {
    const long long gr = row0 + j;
    if (gr >= h) break;
    const float* s = tile + j * kThreads + threadIdx.x;
    float acc = 0.f;
    for (int t = 0; t < ksize; ++t)
      acc = __fadd_rn(acc, __fmul_rn(coef[t], s[t * kThreads]));
    store(out + gr * w + gc, acc);
  }
}

size_t smem_bytes(int pass, int lws, int ksize) {
  const int halo = (ksize - 1) / 2;
  return pass == 0 ? sizeof(float) * lws * (kThreads + 2 * halo)
                   : sizeof(float) * (lws + 2 * halo) * kThreads;
}

template <typename T>
void* kernel_of(int pass) {
  return pass == 0 ? (void*)row_pass_kernel<T> : (void*)col_pass_kernel<T>;
}

template <typename T>
int launch(int pass, const void* x, void* out, int h, int w, int lws,
           int grid, int ksize, const Taps& taps, cudaStream_t stream) {
  const size_t smem = smem_bytes(pass, lws, ksize);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_of<T>(pass), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (pass == 0)
    row_pass_kernel<T><<<grid, kThreads, smem, stream>>>(xi, o, h, w, lws,
                                                         ksize, taps);
  else
    col_pass_kernel<T><<<grid, kThreads, smem, stream>>>(xi, o, h, w, lws,
                                                         ksize, taps);
  return (int)cudaGetLastError();
}

int run(int pass, const void* x, void* out, int h, int w, int lws, int grid,
        int ksize, const float* taps, int dtype, void* stream) {
  if (h < 1 || w < 1 || lws < 1 || grid < 1 || ksize < 1 ||
      ksize % 2 == 0 || ksize >= kMaxTaps)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((h + lws - 1) / lws) *
                          ((w + kThreads - 1) / kThreads);
  if (grid < tiles) return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int i = 0; i < ksize; ++i) t.c[i] = taps[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(pass, x, out, h, w, lws, grid, ksize, t, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(pass, x, out, h, w, lws, grid, ksize, t,
                                 st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// taps: ksize host floats.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int stencil_rows(const void* x, void* out, int h, int w, int lws,
                            int grid, int ksize, const float* taps,
                            int dtype, void* stream) {
  return run(0, x, out, h, w, lws, grid, ksize, taps, dtype, stream);
}

extern "C" int stencil_cols(const void* x, void* out, int h, int w, int lws,
                            int grid, int ksize, const float* taps,
                            int dtype, void* stream) {
  return run(1, x, out, h, w, lws, grid, ksize, taps, dtype, stream);
}

// Resident CTAs per SM that the CUDA runtime reports for one pass (0 =
// rows, 1 = columns) at the plan's lws and ksize (its shared memory).
extern "C" int stencil_occupancy(int pass, int lws, int ksize, int dtype,
                                 int* blocks) {
  if ((pass != 0 && pass != 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(pass, lws, ksize);
  void* fn = dtype == 0 ? kernel_of<float>(pass)
                        : kernel_of<__nv_bfloat16>(pass);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kThreads, smem);
}
