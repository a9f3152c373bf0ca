// Fused paged flash decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode_attention.py::_paged_decode_kernel
// and ::_paged_decode_kernel_int8 (the Pallas kernels that
// paged_decode_attention_pallas launches at :314).
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
// The int8 pool (paged_decode_attention_int8): the caches hold int8
// codes and each physical page carries one f32 scale per KV group,
// scales (B * nb, G) indexed by the page's flat block; a page's codes
// are dequantised (code * scale, in f32, as the JAX reference does) as
// they are staged, so the f32 view of the cache never exists in device
// memory.  Its bound is the int8 prefix: a quarter of the f32 bytes.
//
// Launch geometry: grid (B, G), 128 threads, dynamic shared memory
// 4 * (2 * S * (D + 1) + R * D + R * S) bytes for S = block_s (K/V rows
// padded by one word against bank conflicts, the scaled queries, one
// score row per head).  q fp32 or bf16; caches q's dtype or int8;
// accumulation fp32; output in q's dtype.  The sweep itself (scores,
// online softmax, flush) is csrc/decode_sweep.cuh, shared with
// csrc/decode_attention.cu.

#include <type_traits>

#include "decode_sweep.cuh"

namespace {

using decode_sweep::kThreads;
using decode_sweep::to_f32;

// Stages block_s positions of group g through the row's block table:
// logical page j -> physical flat block (pid % B) * nb + pid / B.
// Pages past the row's last live page stage zeros.  For int8 codes
// (C = int8_t) each value is multiplied by its page's group scale.
template <typename C>
struct PagedStage {
  const C* __restrict__ k;
  const C* __restrict__ v;
  const float* __restrict__ k_scale;   // (B * nb, G); int8 only
  const float* __restrict__ v_scale;
  const int* __restrict__ trow;        // this row's block table
  int B, nb, page, G, D, g, n_pages;

  __device__ __forceinline__ void operator()(int s0, float* s_k, float* s_v,
                                             int dp, int block_s) const {
    const int j0 = s0 / page;
    for (int e = threadIdx.x; e < block_s * D; e += kThreads) {
      const int i = e / D, d = e - i * D;
      const int j = j0 + i / page;
      float kv = 0.f, vv = 0.f;
      if (j < n_pages) {
        const int pid = max(trow[j], 0);
        const size_t blk = (size_t)(pid % B) * nb + pid / B;
        const size_t off = ((blk * page + i % page) * G + g) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        if constexpr (std::is_same<C, int8_t>::value) {
          kv *= k_scale[blk * G + g];
          vv *= v_scale[blk * G + g];
        }
      }
      s_k[i * dp + d] = kv;
      s_v[i * dp + d] = vv;
    }
  }
};

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,           // (B, G, R, D)
                    const C* __restrict__ k_cache,     // (B, Tlen, G, D)
                    const C* __restrict__ v_cache,     // (B, Tlen, G, D)
                    const float* __restrict__ k_scale, // (B * nb, G) | null
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,    // (B, tw)
                    const int* __restrict__ cache_len, // (B,)
                    T* __restrict__ out,               // (B, G, R, D)
                    int B, int Tlen, int G, int R, int D, int tw, int page,
                    int block_s, float scale) {
  const int b = blockIdx.x, g = blockIdx.y;
  const int nb = Tlen / page;
  // positions that exist in the pool row: a retired row's cache_len keeps
  // growing every tick and may pass the row length; its output is
  // discarded, but no read may leave the row's table
  const int clen = max(0, min(cache_len[b], nb * page));
  const PagedStage<C> stage{k_cache, v_cache, k_scale, v_scale,
                            tables + (size_t)b * tw, B, nb, page, G, D, g,
                            (clen + page - 1) / page};
  const size_t qoff = (size_t)(b * G + g) * R * D;
  decode_sweep::sweep(q + qoff, out + qoff, R, D, clen, block_s, scale,
                      stage);
}

template <typename T, typename C>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* tables, const void* cache_len,
           void* out, int B, int Tlen, int G, int R, int D, int tw, int page,
           int block_s, float scale, cudaStream_t stream) {
  const size_t smem = decode_sweep::smem_bytes(block_s, D, R);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T, C><<<dim3(B, G), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(cache_len), static_cast<T*>(out), B, Tlen, G,
      R, D, tw, page, block_s, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int R, int D, int page, int block_s, int Tlen) {
  return R < 1 || R > decode_sweep::kMaxR || D < 1 ||
         D > decode_sweep::kMaxD || page < 1 || block_s < page ||
         block_s % page != 0 || Tlen % page != 0;
}

}  // namespace

// dtype (of q, the output and, here, the caches): 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int paged_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* tables,
                                      const void* cache_len, void* out, int B,
                                      int Tlen, int G, int R, int D, int tw,
                                      int page, int block_s, float scale,
                                      int dtype, void* stream) {
  if (bad_shape(R, D, page, block_s, Tlen)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_cache, v_cache, nullptr, nullptr, tables,
                                cache_len, out, B, Tlen, G, R, D, tw, page,
                                block_s, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_cache, v_cache, nullptr, nullptr, tables, cache_len, out, B,
        Tlen, G, R, D, tw, page, block_s, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The int8 pool: k_cache/v_cache int8 codes (B, Tlen, G, D), k_scale/
// v_scale f32 (B * Tlen / page, G); dtype is q's and the output's.
extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* cache_len, void* out, int B, int Tlen, int G, int R, int D,
    int tw, int page, int block_s, float scale, int dtype, void* stream) {
  if (bad_shape(R, D, page, block_s, Tlen)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q, k_cache, v_cache, k_scale, v_scale,
                                 tables, cache_len, out, B, Tlen, G, R, D, tw,
                                 page, block_s, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(q, k_cache, v_cache, k_scale,
                                         v_scale, tables, cache_len, out, B,
                                         Tlen, G, R, D, tw, page, block_s,
                                         scale, st);
  return (int)cudaErrorInvalidValue;
}
