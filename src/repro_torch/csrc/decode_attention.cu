// Contiguous grouped flash decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel (the
// Pallas kernel that decode_attention_pallas launches at :98, which the
// JAX package vmaps over batch, KV group and query head through
// models/attention.py::pallas_decode_attention).
//
// Computes, for every pool row b and KV group g, the attention of the
// group's R query heads (one new token each) over the first
// cache_len[b] positions of the row's contiguous (T, G, D) cache:
// q (B, G, R, D), k/v caches (B, T, G, D), cache_len (B,) int32 ->
// out (B, G, R, D).  It is the read of the engine's contiguous pool
// (paged=False) and of both gather-then-sweep paths (fused_decode=False,
// after csrc/paged_gather.cu has materialised the logical view), and
// the kernel behind kernels.ops.decode_attention.
//
// Bound on the H100: bytes.  The live prefix's K and V rows,
// sum_b min(cache_len_b, T) * G * D * 2 * dtype_bytes, read once, over
// 3.35 TB/s; about 4 FLOPs per cache value and query head (R = 3 at
// smollm-135m's width), far below the ~295 FLOP/byte ridge.
//
// Design, against that bound: grid (B, G), one CTA per (row, group)
// stages block_s K/V rows of its group once in shared memory for all R
// query heads (the GQA reuse; the JAX kernel runs one instance per
// (row, group, head) and reads each group's cache R times), and stops at
// cache_len instead of masking the whole row.  The staged rows past
// cache_len are zeros, so stale cache words never enter the sum.
// cache_len is clamped to [0, T]: a retired slot's length keeps growing
// and may pass T; a row of length 0 writes zeros, not NaN.  block_s is
// the mapper's plan_cache_block (a multiple of 16) and stays a runtime
// argument.  The sweep (scores, online softmax, flush) is
// csrc/decode_sweep.cuh, shared with csrc/paged_decode_attention.cu.
// Left for later work: split-KV over the sequence to fill the SMs (the
// serving shape's B * G = 24 CTAs leave most of the 132 SMs idle),
// 16-byte vector loads, cp.async/TMA double buffering.
//
// Launch geometry: grid (B, G), 128 threads, dynamic shared memory
// 4 * (2 * S * (D + 1) + R * D + R * S) bytes for S = block_s.  Inputs
// fp32 or bf16 (q and caches of one dtype); accumulation fp32; output in
// q's dtype.

#include "decode_sweep.cuh"

namespace {

using decode_sweep::kThreads;
using decode_sweep::to_f32;

// Stages positions s0 .. s0+block_s-1 of group g from the row's cache;
// positions at or past clen stage zeros.
template <typename T>
struct RowStage {
  const T* __restrict__ k;             // this row's (T, G, D) cache
  const T* __restrict__ v;
  int G, D, g, clen;

  __device__ __forceinline__ void operator()(int s0, float* s_k, float* s_v,
                                             int dp, int block_s) const {
    for (int e = threadIdx.x; e < block_s * D; e += kThreads) {
      const int i = e / D, d = e - i * D;
      const int p = s0 + i;
      float kv = 0.f, vv = 0.f;
      if (p < clen) {
        const size_t off = ((size_t)p * G + g) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      s_k[i * dp + d] = kv;
      s_v[i * dp + d] = vv;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q,           // (B, G, R, D)
              const T* __restrict__ k_cache,     // (B, Tlen, G, D)
              const T* __restrict__ v_cache,     // (B, Tlen, G, D)
              const int* __restrict__ cache_len, // (B,)
              T* __restrict__ out,               // (B, G, R, D)
              int Tlen, int G, int R, int D, int block_s, float scale) {
  const int b = blockIdx.x, g = blockIdx.y;
  const int clen = max(0, min(cache_len[b], Tlen));
  const size_t row = (size_t)b * Tlen * G * D;
  const RowStage<T> stage{k_cache + row, v_cache + row, G, D, g, clen};
  const size_t qoff = (size_t)(b * G + g) * R * D;
  decode_sweep::sweep(q + qoff, out + qoff, R, D, clen, block_s, scale,
                      stage);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cache_len,
           void* out, int B, int Tlen, int G, int R, int D, int block_s,
           float scale, cudaStream_t stream) {
  const size_t smem = decode_sweep::smem_bytes(block_s, D, R);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T><<<dim3(B, G), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cache_len),
      static_cast<T*>(out), Tlen, G, R, D, block_s, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* cache_len,
                                void* out, int B, int Tlen, int G, int R,
                                int D, int block_s, float scale, int dtype,
                                void* stream) {
  if (R < 1 || R > decode_sweep::kMaxR || D < 1 || D > decode_sweep::kMaxD ||
      block_s < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, cache_len, out, B, Tlen, G, R,
                         D, block_s, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, cache_len, out, B, Tlen,
                                 G, R, D, block_s, scale, st);
  return (int)cudaErrorInvalidValue;
}
