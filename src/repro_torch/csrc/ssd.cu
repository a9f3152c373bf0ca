// Mamba-2 chunked SSD (state-space duality) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd.py::_ssd_kernel (the Pallas kernel that
// ssd_pallas_single launches at :67, vmapped over heads by ssd_pallas).
//
// For each head h and each chunk of c steps, in order, with the (N, P)
// f32 state S zero at chunk 0 (cum = cumsum of the chunk's log-decay a):
//   y = ((C B^T) o tril(exp(cum_t - cum_s))) X + (C o exp(cum)) S
//   S <- exp(cum_last) S + (B o exp(cum_last - cum))^T X
// x (L, H, P), b, c (L, G, N) and out (L, H, P) in one dtype (f32 or
// bf16); a (L, H) f32; head h reads group h / (H / G) (no repeated copy
// of b and c).
//
// Bound on the H100: operations.  Counted as the reference computes them
// (full c x c scores, the causal half included): L H (2c(N + P) + 4NP)
// FLOPs, 7.5 GFLOP at mamba2-1.3b's layer (L 2048, H 64, P 64, N 128)
// and c 64, against ~70 MB moved in f32.
//
// Design (simple and right first): one CTA of 256 threads per head walks
// its chunks in order -- the loop takes the place of the TPU's sequential
// grid -- with S in shared memory (N x P f32, 32 KB at N 128, P 64).  A
// chunk is tiled in 64-row tiles of t and s, so a chunk of any length
// fits: at c 256 (FIXED) b and c alone would be 256 KB in f32, above the
// 227 KB a block may claim.  Per t-tile: the C tile is staged, the
// carried-state term C S is taken first, then for each s-tile at or
// below the diagonal (s-tiles above it are skipped) the scores C B^T are
// formed, masked and decayed, staged, and multiplied into X.  After the
// chunk's last t-tile the state is advanced from its B and X tiles.  The four
// products run from shared memory on a 16 x 16 thread grid, each thread
// holding a micro-tile of outputs in registers (rows ty + 16 i, columns
// tx + 16 j); B and C tiles are staged with a padded row stride so that
// neither orientation of B conflicts on a bank.  The causal mask selects
// before the exponent: exp(cum_t - cum_s) is evaluated only for s <= t
// (a is negative, so s > t would overflow to inf, and inf * 0 is NaN).
// The kernel takes L % chunk == 0 (the wrapper halves the chunk first).
// No library kernel, no tensor cores (wgmma and TMA are later work).
// Grid: H CTAs (64 at mamba2-1.3b, on 132 SMs: undersubscribed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // rows of t and of s per tile
constexpr int kMaxN = 128;           // state width N
constexpr int kMaxP = 64;            // head width P
constexpr int kNS = kMaxN + 1;       // padded row stride of the B, C tiles
constexpr int kSS = kTile + 1;       // padded row stride of the score tile

// shared-memory floats before the chunk's cum array
constexpr int kFixedFloats =
    kMaxN * kMaxP + 2 * kTile * kNS + kTile * kMaxP + kTile * kSS + kTile;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage `rows` rows of a (L, G, N) operand starting at row0 (group g)
// into a kTile x kNS tile; rows past `rows` are zero.
template <typename T>
__device__ void stage_bc(float* dst, const T* __restrict__ src, long long row0,
                         int rows, int G, int g, int N) {
  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int r = i / N, k = i - r * N;
    dst[r * kNS + k] =
        r < rows ? to_f32(src[((row0 + r) * G + g) * (long long)N + k]) : 0.f;
  }
}

// Stage `rows` rows of x (L, H, P) for head h into a kTile x kMaxP tile.
template <typename T>
__device__ void stage_x(float* dst, const T* __restrict__ src, long long row0,
                        int rows, int H, int h, int P) {
  for (int i = threadIdx.x; i < kTile * P; i += kThreads) {
    const int r = i / P, p = i - r * P;
    dst[r * kMaxP + p] =
        r < rows ? to_f32(src[((row0 + r) * H + h) * (long long)P + p]) : 0.f;
  }
}

// acc[i][j] += sum_k A[(ty + 16 i) * a_rs + k]
//                    * B[k * b_ks + (tx + 16 j) * b_cs]
template <int MI, int NJ>
__device__ __forceinline__ void mma_smem(float (&acc)[MI][NJ],
                                         const float* A, int a_rs,
                                         const float* B, int b_ks, int b_cs,
                                         int K, int ty, int tx) {
  for (int k = 0; k < K; ++k) {
    float av[MI], bv[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) av[i] = A[(ty + 16 * i) * a_rs + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = B[k * b_ks + (tx + 16 * j) * b_cs];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
           const T* __restrict__ b, const T* __restrict__ c,
           T* __restrict__ out, int L, int H, int G, int N, int P,
           int chunk) {
  extern __shared__ float smem[];
  float* S = smem;                          // kMaxN x kMaxP state
  float* Ct = S + kMaxN * kMaxP;            // kTile x kNS
  float* Bt = Ct + kTile * kNS;             // kTile x kNS
  float* Xt = Bt + kTile * kNS;             // kTile x kMaxP
  float* Sc = Xt + kTile * kMaxP;           // kTile x kSS scores
  float* wv = Sc + kTile * kSS;             // kTile state-update weights
  float* cum = wv + kTile;                  // chunk

  const int h = blockIdx.x, g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int ntile = (chunk + kTile - 1) / kTile;

  // zero the state and every tile once: columns past N and P stay zero
  for (int i = tid; i < kFixedFloats; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  for (long long c0 = 0; c0 < L; c0 += chunk) {
    // cum = cumsum(a) over the chunk: warp 0, each lane a run of steps
    if (warp == 0) {
      const int per = (chunk + 31) / 32;
      const int beg = min(lane * per, chunk), end = min(beg + per, chunk);
      float run = 0.f;
      for (int t = beg; t < end; ++t) {
        run += a[(c0 + t) * H + h];
        cum[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float excl = incl - run;
      for (int t = beg; t < end; ++t) cum[t] += excl;
    }
    __syncthreads();
    const float total = cum[chunk - 1];

    // outputs, one 64-row t-tile at a time
    for (int it = 0; it < ntile; ++it) {
      const int t0 = it * kTile, trows = min(kTile, chunk - t0);
      stage_bc(Ct, c, c0 + t0, trows, G, g, N);
      __syncthreads();
      float acc[4][4] = {};
      mma_smem(acc, Ct, kNS, S, kMaxP, 1, N, ty, tx);        // C S
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        const float e = t < chunk ? expf(cum[t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      for (int is = 0; is <= it; ++is) {
        const int s0 = is * kTile, srows = min(kTile, chunk - s0);
        stage_bc(Bt, b, c0 + s0, srows, G, g, N);
        stage_x(Xt, x, c0 + s0, srows, H, h, P);
        __syncthreads();
        float sc[4][4] = {};
        mma_smem(sc, Ct, kNS, Bt, 1, kNS, N, ty, tx);        // C B^T
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            // select before the exponent: only s <= t is ever exponentiated
            const float v =
                (s <= t && t < chunk) ? sc[i][j] * expf(cum[t] - cum[s]) : 0.f;
            Sc[(ty + 16 * i) * kSS + tx + 16 * j] = v;
          }
        }
        __syncthreads();
        mma_smem(acc, Sc, kSS, Xt, kMaxP, 1, srows, ty, tx);  // scores X
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= chunk) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) store(out + ((c0 + t) * H + h) * (long long)P + p,
                           acc[i][j]);
        }
      }
    }

    // S <- exp(total) S + sum_s (B_s exp(total - cum_s))^T X_s; thread
    // (ty, tx) owns S rows ty + 16 i (i < 8) and columns tx + 16 j
    float st[8][4];
    const float et = expf(total);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st[i][j] = S[(ty + 16 * i) * kMaxP + tx + 16 * j] * et;
    for (int is = 0; is < ntile; ++is) {
      const int s0 = is * kTile, srows = min(kTile, chunk - s0);
      stage_bc(Bt, b, c0 + s0, srows, G, g, N);
      stage_x(Xt, x, c0 + s0, srows, H, h, P);
      if (tid < kTile)
        wv[tid] = tid < srows ? expf(total - cum[s0 + tid]) : 0.f;
      __syncthreads();
      for (int k = 0; k < srows; ++k) {
        const float w = wv[k];
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = Bt[k * kNS + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Xt[k * kMaxP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] = fmaf(av[i], bv[j], st[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        S[(ty + 16 * i) * kMaxP + tx + 16 * j] = st[i][j];
    __syncthreads();
  }
}

size_t smem_bytes(int chunk) {
  return sizeof(float) * ((size_t)kFixedFloats + (size_t)chunk);
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           void* out, int L, int H, int G, int N, int P, int chunk,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(out), L, H, G, N, P, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int chunk, int* blocks) {
  const size_t smem = smem_bytes(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_kernel<T>, kThreads, smem);
}

}  // namespace

// dtype of x, b, c and out: 0 = float32, 1 = bfloat16; a is float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssd(const void* x, const void* a, const void* b, const void* c,
                   void* out, int L, int H, int G, int N, int P, int chunk,
                   int dtype, void* stream) {
  if (L < 1 || H < 1 || G < 1 || H % G || N < 1 || N > kMaxN || P < 1 ||
      P > kMaxP || chunk < 1 || L % chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, a, b, c, out, L, H, G, N, P, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, c, out, L, H, G, N, P, chunk, st);
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM that the CUDA runtime reports at this chunk length.
extern "C" int ssd_occupancy(int chunk, int dtype, int* blocks) {
  if (dtype == 0) return occupancy<float>(chunk, blocks);
  if (dtype == 1) return occupancy<__nv_bfloat16>(chunk, blocks);
  return (int)cudaErrorInvalidValue;
}
