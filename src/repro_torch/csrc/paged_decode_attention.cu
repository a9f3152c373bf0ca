// Fused paged flash decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode_attention.py::_paged_decode_kernel
// (the Pallas kernel that paged_decode_attention_pallas launches at :314).
//
// Computes, for every pool row b and KV group g, the attention of the
// group's R query heads (one new token each) over the row's first
// cache_len[b] KV positions, read through the row's block table on the
// column-major physical grid of the serving pool:
//   logical page j -> pid = max(table[b, j], 0)
//                  -> flat block (pid % B) * nb + pid / B of the
//                     (B * nb, page, G, D) view of the (B, T, G, D) cache.
// Unmapped (-1) entries clamp to block 0; whatever they would contribute
// lies at or past cache_len and is masked.
//
// Bound on the H100: bytes.  A CTA reads cache_len * D values of K and as
// many of V for its group and does about 4 FLOPs per value and query head
// (R = 3 at smollm-135m's width), far below the ~295 FLOP/byte ridge.  The
// least time is sum_b cache_len_b * G * D * 2 * dtype_bytes over 3.35 TB/s.
//
// Design, against that bound: one CTA per (row, group) stages the group's
// K/V rows once into shared memory and lets all R query heads of the
// group reuse them (the GQA reuse; the cache is never expanded to H
// heads); the sweep walks the row's own block table and stops at
// cache_len instead of masking every page of the pool row, so each byte
// of the live prefix is read once and nothing past it is read at all.
// The staging chunk block_s (a whole number of pages) is the mapper's
// Eq. 1 plan and stays a runtime argument.  The online softmax
// (running max m, sum l, accumulator acc) is updated once per chunk.
// Left for later work: split-KV over the sequence to fill the SMs (the
// B*G = 24 CTAs of the serving shape leave most of the 132 SMs idle),
// 16-byte vector loads, cp.async/TMA double buffering.
//
// Launch geometry: grid (B, G), 128 threads, dynamic shared memory
// 4 * (2 * S * (D + 1) + R * D + R * S) bytes for S = block_s (K/V rows
// padded by one word against bank conflicts, the scaled queries, one
// score row per head).  Inputs fp32 or bf16; accumulation fp32; output
// in the input dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxR = 8;
constexpr int kMaxD = 128;
constexpr int kAccPerThread = kMaxR * kMaxD / kThreads;

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
paged_decode_kernel(const T* __restrict__ q,           // (B, G, R, D)
                    const T* __restrict__ k_cache,     // (B, Tlen, G, D)
                    const T* __restrict__ v_cache,     // (B, Tlen, G, D)
                    const int* __restrict__ tables,    // (B, tw)
                    const int* __restrict__ cache_len, // (B,)
                    T* __restrict__ out,               // (B, G, R, D)
                    int B, int Tlen, int G, int R, int D, int tw, int page,
                    int block_s, float scale) {
  extern __shared__ float smem[];
  __shared__ float s_m[kMaxR], s_l[kMaxR], s_alpha[kMaxR];
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int dp = D + 1;
  float* s_k = smem;                    // (block_s, D + 1)
  float* s_v = s_k + block_s * dp;      // (block_s, D + 1)
  float* s_q = s_v + block_s * dp;      // (R, D), pre-scaled
  float* s_p = s_q + R * D;             // (R, block_s) scores, then probs

  const int nb = Tlen / page;
  // positions that exist in the pool row: a retired row's cache_len keeps
  // growing every tick and may pass the row length; its output is
  // discarded, but no read may leave the row's table
  const int clen = max(0, min(cache_len[b], nb * page));
  const int n_pages = (clen + page - 1) / page;
  const int* trow = tables + (size_t)b * tw;
  const size_t qoff = (size_t)(b * G + g) * R * D;

  for (int i = tid; i < R * D; i += kThreads) s_q[i] = to_f32(q[qoff + i]) * scale;
  if (tid < R) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < clen; s0 += block_s) {
    const int j0 = s0 / page;
    // stage this chunk's pages (group g's rows) as f32
    for (int e = tid; e < block_s * D; e += kThreads) {
      const int i = e / D, d = e - i * D;
      const int j = j0 + i / page;
      float kv = 0.f, vv = 0.f;
      if (j < n_pages) {
        const int pid = max(trow[j], 0);
        const size_t blk = (size_t)(pid % B) * nb + pid / B;
        const size_t off = ((blk * page + i % page) * G + g) * D + d;
        kv = to_f32(k_cache[off]);
        vv = to_f32(v_cache[off]);
      }
      s_k[i * dp + d] = kv;
      s_v[i * dp + d] = vv;
    }
    __syncthreads();

    // scores, masked by cache_len
    for (int e = tid; e < R * block_s; e += kThreads) {
      const int r = e / block_s, i = e - r * block_s;
      float s = -INFINITY;
      if (s0 + i < clen) {
        const float* kr = s_k + i * dp;
        const float* qr = s_q + r * D;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = dot;
      }
      s_p[r * block_s + i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query head
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += kThreads / 32) {
      float* pr = s_p + r * block_s;
      float mx = -INFINITY;
      for (int i = lane; i < block_s; i += 32) mx = fmaxf(mx, pr[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
      for (int i = lane; i < block_s; i += 32) {
        const float s = pr[i];
        const float p = isinf(s) ? 0.f : expf(s - m_safe);
        pr[i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = isinf(m_prev) ? 0.f : expf(m_prev - m_safe);
        s_alpha[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, one (head, dim) output per slot
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int o = tid + a * kThreads;
      if (o < R * D) {
        const int r = o / D, d = o - r * D;
        const float* pr = s_p + r * block_s;
        float sum = 0.f;
        for (int i = 0; i < block_s; ++i) sum += pr[i] * s_v[i * dp + d];
        acc[a] = acc[a] * s_alpha[r] + sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int o = tid + a * kThreads;
    if (o < R * D) {
      const int r = o / D;
      store(out + qoff + o, acc[a] / fmaxf(s_l[r], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* cache_len, void* out, int B, int Tlen, int G, int R,
           int D, int tw, int page, int block_s, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)block_s * (D + 1) +
                                       (size_t)R * D + (size_t)R * block_s);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T><<<dim3(B, G), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(cache_len), static_cast<T*>(out), B, Tlen, G,
      R, D, tw, page, block_s, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int paged_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* tables,
                                      const void* cache_len, void* out, int B,
                                      int Tlen, int G, int R, int D, int tw,
                                      int page, int block_s, float scale,
                                      int dtype, void* stream) {
  if (R < 1 || R > kMaxR || D < 1 || D > kMaxD || page < 1 ||
      block_s % page != 0 || Tlen % page != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, tables, cache_len, out, B, Tlen,
                         G, R, D, tw, page, block_s, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, tables, cache_len, out,
                                 B, Tlen, G, R, D, tw, page, block_s, scale,
                                 st);
  return (int)cudaErrorInvalidValue;
}
