// Tiled matmul, C[M, N] = A[M, K] @ B[K, N] with an fp32 accumulator,
// on the CUDA cores, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/matmul.py::_matmul_kernel (the Pallas
// kernel that matmul_pallas launches at :66), the paper's sgemm, for the
// bf16 operands the tensor-core kernel cannot take (K or N not a
// multiple of 8, or a pointer off 16 bytes: TMA needs 16-byte strides).
// float32 operands run as 3xTF32 on the tensor cores
// (csrc/matmul_tf32x3.cu), other bf16 ones on csrc/matmul_tc.cu.
//
// Bound on the H100: 2 M N K FLOPs against (M K + K N) inputs read and
// M N outputs written; at 4096^3 that is ~1,400 FLOP/byte, far above the
// machine balance, so operations bound it: 2 M N K over 989 TF/s, the
// bf16 tensor-core rate, which this kernel (scalar fmaf) cannot reach.
//
// Design: the mapping policy decides lws, the number of outputs a thread
// owns, held in registers as a TM x TN micro-tile.  A CTA is a 16 x 16
// grid of threads and owns a BM x BN = (16 TM) x (16 TN) output tile;
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j of it.  K is
// swept in bk steps: the A tile (BM x bk) is staged in shared memory as
// fp32, transposed, with one word of padding per row so the coalesced
// global reads store without bank conflicts; the B tile (bk x BN) as
// fp32 rows.  In the inner loop a warp reads two A values (broadcast)
// and 16 consecutive B values per step.  TM and TN size register arrays
// and so are template parameters: 1, 2, 4 or 8 each (lws = TM TN from 1
// to 64; an 8 x 8 tile already takes ~100 registers a thread).  Edges
// are zero-filled on load and masked on store: no padded copies.
// Inputs bf16; output fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGrid = 16;                   // 16 x 16 threads per CTA
constexpr int kThreads = kGrid * kGrid;

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const __nv_bfloat16* __restrict__ A,
              const __nv_bfloat16* __restrict__ B,
              void* __restrict__ C, int M, int N, int K, int bk,
              int out_bf16) {
  constexpr int BM = kGrid * TM, BN = kGrid * TN, LDA = BM + 1;
  extern __shared__ float smem[];
  float* As = smem;                         // (bk, BM + 1): A^T tile
  float* Bs = smem + bk * LDA;              // (bk, BN)
  const int tid = threadIdx.x;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    for (int e = tid; e < BM * bk; e += kThreads) {
      const int r = e / bk, c = e % bk;
      const int gr = row0 + r, gc = k0 + c;
      As[c * LDA + r] =
          (gr < M && gc < K) ? __bfloat162float(A[(size_t)gr * K + gc])
                             : 0.f;
    }
    for (int e = tid; e < bk * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r * BN + c] =
          (gr < K && gc < N) ? __bfloat162float(B[(size_t)gr * N + gc])
                             : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * LDA + ty + kGrid * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * BN + tx + kGrid * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + kGrid * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + kGrid * j;
      if (gc >= N) continue;
      const size_t o = (size_t)gr * N + gc;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(C)[o] = __float2bfloat16(acc[i][j]);
      else
        static_cast<float*>(C)[o] = acc[i][j];
    }
  }
}

bool legal_tile(int t) { return t == 1 || t == 2 || t == 4 || t == 8; }

size_t smem_bytes(int tm, int tn, int bk) {
  return sizeof(float) * (size_t)bk * ((kGrid * tm + 1) + kGrid * tn);
}

template <int TM, int TN>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           int bk, int out_bf16, cudaStream_t stream) {
  const size_t smem = smem_bytes(TM, TN, bk);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel<TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kGrid * TN - 1) / (kGrid * TN),
                  (M + kGrid * TM - 1) / (kGrid * TM));
  matmul_kernel<TM, TN><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), c, M, N, K, bk, out_bf16);
  return (int)cudaGetLastError();
}

template <int TM, int TN>
int occupancy(int bk, int* blocks) {
  const size_t smem = smem_bytes(TM, TN, bk);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel<TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, matmul_kernel<TM, TN>, kThreads, smem);
}

// One call per (TM, TN) instantiation: F is launch or occupancy.
#define MATMUL_DISPATCH_TN(TM, F, ...)                       \
  switch (tn) {                                              \
    case 1: return F<TM, 1>(__VA_ARGS__);                    \
    case 2: return F<TM, 2>(__VA_ARGS__);                    \
    case 4: return F<TM, 4>(__VA_ARGS__);                    \
    case 8: return F<TM, 8>(__VA_ARGS__);                    \
  }                                                          \
  return (int)cudaErrorInvalidValue;

#define MATMUL_DISPATCH(F, ...)                                      \
  switch (tm) {                                                      \
    case 1: { MATMUL_DISPATCH_TN(1, F, __VA_ARGS__) }                \
    case 2: { MATMUL_DISPATCH_TN(2, F, __VA_ARGS__) }                \
    case 4: { MATMUL_DISPATCH_TN(4, F, __VA_ARGS__) }                \
    case 8: { MATMUL_DISPATCH_TN(8, F, __VA_ARGS__) }                \
  }                                                                  \
  return (int)cudaErrorInvalidValue;

int launch_tile(int tm, int tn, const void* a, const void* b, void* c,
                int M, int N, int K, int bk, int out_bf16,
                cudaStream_t st) {
  MATMUL_DISPATCH(launch, a, b, c, M, N, K, bk, out_bf16, st)
}

int occupancy_tile(int tm, int tn, int bk, int* blocks) {
  MATMUL_DISPATCH(occupancy, bk, blocks)
}

}  // namespace

// dtype (of A and B): 1 = bfloat16 (float32, 0, is refused: it runs as
// 3xTF32); out_dtype: 0 = float32, 1 = bfloat16; tm, tn in {1, 2, 4,
// 8}; bk a multiple of 16.  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int matmul(const void* a, const void* b, void* c, int M, int N,
                      int K, int tm, int tn, int bk, int dtype,
                      int out_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || !legal_tile(tm) || !legal_tile(tn) ||
      bk < 16 || bk % 16 != 0 || (out_dtype != 0 && out_dtype != 1) ||
      (M + kGrid * tm - 1) / (kGrid * tm) > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return launch_tile(tm, tn, a, b, c, M, N, K, bk, out_dtype,
                     static_cast<cudaStream_t>(stream));
}

// Resident CTAs per SM that the CUDA runtime reports for one instantiation
// (dtype 1, bfloat16, as for matmul).
extern "C" int matmul_occupancy(int tm, int tn, int bk, int dtype,
                                int* blocks) {
  if (!legal_tile(tm) || !legal_tile(tn) || bk < 16 || bk % 16 != 0 ||
      dtype != 1)
    return (int)cudaErrorInvalidValue;
  return occupancy_tile(tm, tn, bk, blocks);
}
