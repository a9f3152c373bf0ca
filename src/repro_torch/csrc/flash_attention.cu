// Causal flash attention (prefill) for Hopper (sm_90a), grouped-query form.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// Pallas kernel that flash_attention_pallas launches at :101), which the
// JAX package vmaps per (batch, kv group, query head) in
// models/attention.py::pallas_prefill_attention; and the jnp blocked
// sweep tiled_prefill_attention that chunked prefill runs with a traced
// q_offset (models/transformer.py::chunk_prefill_step).  One kernel
// serves both: q_offset is a runtime argument.
//
// Computes out[b, i, g, r] = softmax_k(q[b, i, g, r] . k[b, k, g] * scale)
// @ v[b, k, g] over keys k < Sk with k <= i + q_offset (causal, with the
// query block sitting q_offset positions into the key sequence).
//
// Bound on the H100: at the serving shapes (head_dim 64, prompts of a few
// hundred tokens) the score and value products are ~2 * 2 * Sq * Sk_eff *
// D FLOPs per head against ~2 * Sk * D K/V values read per KV group, so
// operations dominate for long prompts and bytes for short chunks; the
// bound is max(FLOPs / peak, bytes / 3.35 TB/s), with the bf16 tensor-core
// peak (989 TF/s) or, for fp32 inputs, the 67 TF/s CUDA-core peak.
//
// Design: one CTA per (query tile, b, g, r); one thread owns one query
// row, holding its scaled query and its f32 accumulator in registers.
// K/V tiles of block_k rows are staged once per CTA in shared memory as
// f32 and every thread of the tile reads them as broadcasts; the score
// row of each thread lives in shared memory with an odd stride (no bank
// conflicts).  Key tiles wholly in a tile's causal future are skipped.
// This runs on CUDA cores: far from the tensor-core bound, which needs
// wgmma with bf16 operands from shared memory, a producer warp keeping
// TMA loads in flight, and K/V shared by the R query heads of a group —
// work for a later PR.
//
// Launch geometry: grid (ceil(Sq / block_q), B * G * R), round_up(block_q,
// 32) threads, dynamic shared memory 4 * (2 * block_k * D + threads *
// (block_k + 1)) bytes.  D = 64 only (smollm-135m's head_dim; another
// head_dim comes with the model that needs it).  Inputs fp32 or bf16;
// accumulation fp32; output in the input dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHeadDim = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_kernel(const T* __restrict__ q,   // (B, Sq, G, R, D)
             const T* __restrict__ k,   // (B, Sk, G, D)
             const T* __restrict__ v,   // (B, Sk, G, D)
             T* __restrict__ out,       // (B, Sq, G, R, D)
             int B, int Sq, int Sk, int G, int R, int block_q, int block_k,
             int q_offset, float scale) {
  extern __shared__ float smem[];
  float* s_k = smem;                       // (block_k, D)
  float* s_v = s_k + block_k * D;          // (block_k, D)
  float* s_s = s_v + block_k * D;          // (threads, block_k + 1)
  const int tid = threadIdx.x;
  const int bgr = blockIdx.y;
  const int r = bgr % R;
  const int g = (bgr / R) % G;
  const int b = bgr / (R * G);
  const int q0 = blockIdx.x * block_q;
  const int row = q0 + tid;
  const bool active = tid < block_q && row < Sq;
  const int q_pos = row + q_offset;
  const size_t qoff = ((((size_t)b * Sq + row) * G + g) * R + r) * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f32(q[qoff + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  float* srow = s_s + tid * (block_k + 1);

  // the last key any row of this query tile may attend to
  const int q_last = min(q0 + block_q, Sq) - 1 + q_offset;
  const int k_end = min(Sk, q_last + 1);
  for (int k0 = 0; k0 < k_end; k0 += block_k) {
    for (int e = tid; e < block_k * D; e += blockDim.x) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * G + g) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      s_k[e] = kv;
      s_v[e] = vv;
    }
    __syncthreads();
    if (active) {
      float mt = -INFINITY;
      for (int j = 0; j < block_k; ++j) {
        const int kp = k0 + j;
        float s = -INFINITY;
        if (kp < Sk && kp <= q_pos) {
          const float* kr = s_k + j * D;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
          s = dot;
        }
        srow[j] = s;
        mt = fmaxf(mt, s);
      }
      const float m_new = fmaxf(m, mt);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      const float alpha = isinf(m) ? 0.f : expf(m - m_safe);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
      for (int j = 0; j < block_k; ++j) {
        const float s = srow[j];
        if (isinf(s)) continue;
        const float p = expf(s - m_safe);
        l += p;
        const float* vr = s_v + j * D;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += p * vr[d];
      }
      m = m_new;
    }
    __syncthreads();
  }
  if (active) {
    const float lsafe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) store(out + qoff + d, acc[d] / lsafe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int G, int R, int block_q, int block_k,
           int q_offset, float scale, cudaStream_t stream) {
  const int threads = (block_q + 31) / 32 * 32;
  const size_t smem =
      sizeof(float) * (2 * (size_t)block_k * D + (size_t)threads * (block_k + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + block_q - 1) / block_q, B * G * R);
  flash_kernel<T, D><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), B, Sq, Sk, G, R,
      block_q, block_k, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int G, int R,
                               int D, int block_q, int block_k, int q_offset,
                               float scale, int dtype, void* stream) {
  if (D != kHeadDim || block_q < 1 || block_q > 128 || block_k < 1 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kHeadDim>(q, k, v, out, B, Sq, Sk, G, R, block_q,
                                   block_k, q_offset, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, kHeadDim>(q, k, v, out, B, Sq, Sk, G, R,
                                           block_q, block_k, q_offset, scale,
                                           st);
  return (int)cudaErrorInvalidValue;
}
