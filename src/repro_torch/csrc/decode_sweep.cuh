// The flash-decode sweep shared by the two decode kernels of the port
// (csrc/paged_decode_attention.cu and csrc/decode_attention.cu).
//
// One CTA owns the R query heads of one (row, KV group): it stages
// block_s cache positions of the group's K and V at a time in shared
// memory (as f32, whatever the cache's dtype), scores all R heads
// against them, and carries the online softmax (running max m, sum l,
// accumulator acc) across chunks until it passes the row's cache
// length.  The kernels differ only in how a chunk is staged: through
// the row's block table (paged, f32/bf16 or int8 codes dequantised on
// the way in) or from the row's contiguous cache.  A Stage functor
// supplies that step:
//
//   stage(s0, s_k, s_v, dp, block_s)  fills rows [0, block_s) of the
//   padded (block_s, D + 1) f32 tiles with positions s0 .. s0+block_s-1
//   of group g; rows it has no data for must be finite (zeros).
//
// Scores past clen are -inf and contribute nothing; a row with clen 0
// (a retired slot) writes zeros (l is clamped at 1e-30, as the JAX
// kernels' flush does).
//
// Dynamic shared memory: 4 * (2 * S * (D + 1) + R * D + R * S) bytes for
// S = block_s (repro_torch.core.mapper.decode_smem_bytes mirrors it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_sweep {

constexpr int kThreads = 128;
constexpr int kMaxR = 8;
constexpr int kMaxD = 128;
constexpr int kAccPerThread = kMaxR * kMaxD / kThreads;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

inline size_t smem_bytes(int block_s, int D, int R) {
  return sizeof(float) * (2 * (size_t)block_s * (D + 1) + (size_t)R * D +
                          (size_t)R * block_s);
}

// q and out point at this CTA's (R, D) query rows / output rows.
template <typename T, typename Stage>
__device__ __forceinline__ void sweep(const T* __restrict__ q,
                                      T* __restrict__ out, int R, int D,
                                      int clen, int block_s, float scale,
                                      const Stage& stage) {
  extern __shared__ float smem[];
  __shared__ float s_m[kMaxR], s_l[kMaxR], s_alpha[kMaxR];
  const int tid = threadIdx.x;
  const int dp = D + 1;
  float* s_k = smem;                    // (block_s, D + 1)
  float* s_v = s_k + block_s * dp;      // (block_s, D + 1)
  float* s_q = s_v + block_s * dp;      // (R, D), pre-scaled
  float* s_p = s_q + R * D;             // (R, block_s) scores, then probs

  for (int i = tid; i < R * D; i += kThreads) s_q[i] = to_f32(q[i]) * scale;
  if (tid < R) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < clen; s0 += block_s) {
    stage(s0, s_k, s_v, dp, block_s);
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
      store(out + o, acc[a] / fmaxf(s_l[r], 1e-30f));
    }
  }
}

}  // namespace decode_sweep
