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
// lies at or past cache_len and is never staged.
//
// Bound on the H100: bytes.  A row reads cache_len * D values of K and as
// many of V per group and does about 4 FLOPs per value and query head
// (R = 3 at smollm-135m's width), far below the ~295 FLOP/byte ridge.  The
// least time is sum_b cache_len_b * G * D * 2 * dtype_bytes over 3.35 TB/s,
// under a microsecond at the serving shape, so latency bounds the kernel
// in practice: the chain of dependent loads one CTA walks.
//
// Design, against that: the split-KV sweep of csrc/decode_sweep.cuh.
// The grid is (B, G, n_split): each row is cut into splits of W
// positions (the mapper's Eq. 1 plan over the resident CTA slots, a
// whole number of block_s and so of pages), so the SMs share a long row.
// A split resolves each page of its chunks once (table entry, flat
// block, int8 scales) into shared memory, stages the group's K/V rows in
// the cache's dtype by cp.async into a 4-stage ring for all R query
// heads of the group (the GQA reuse; the cache is never expanded to H
// heads), and stops at cache_len, so each byte of the live prefix is
// read once and nothing past it at all.  The partials of a row's splits
// are merged by its last split to finish, in the same launch.
//
// The int8 pool (paged_decode_attention_int8): the caches hold int8
// codes and each physical page carries one f32 scale per KV group,
// scales (B * nb, G) indexed by the page's flat block; codes are staged
// as int8 and dequantised (code * scale, in f32, as the JAX reference
// does) as they are scored, so the f32 view of the cache never exists.
// Its bound is the int8 prefix: a quarter of the f32 bytes.
//
// Launch geometry: grid (B, G * n_hc, n_split), 128 threads, dynamic
// shared memory decode_sweep::smem_bytes(D, R / n_hc, page, cache bytes),
// under 48 KB; n_hc = decode_sweep::head_chunks(R, D) runs of heads a
// group (1 for R <= 8 at D <= 128; R 12 at D 192: three runs of 4).  q
// fp32 or bf16; caches q's dtype or int8; accumulation fp32; output in
// q's dtype.

#include "decode_sweep.cuh"

namespace {

using decode_sweep::Params;

template <typename T, typename C, int RB, int EPL>
__global__ void __launch_bounds__(decode_sweep::kThreads,
                                  decode_sweep::min_ctas(EPL))
paged_decode_kernel(const Params p) {
  decode_sweep::sweep<T, C, true, RB, EPL>(p);
}

template <typename T, typename C>
int launch(Params p, cudaStream_t stream) {
  constexpr int es = sizeof(C);
  if (p.D > decode_sweep::kNarrowD) {   // 8 values a lane, up to 4 heads
    switch (decode_sweep::heads_bucket(p.R, p.D)) {
      case 1:
        return decode_sweep::launch(paged_decode_kernel<T, C, 1, 8>, p, es,
                                    stream);
      case 2:
        return decode_sweep::launch(paged_decode_kernel<T, C, 2, 8>, p, es,
                                    stream);
      case 3:
        return decode_sweep::launch(paged_decode_kernel<T, C, 3, 8>, p, es,
                                    stream);
      default:
        return decode_sweep::launch(paged_decode_kernel<T, C, 4, 8>, p, es,
                                    stream);
    }
  }
  switch (decode_sweep::heads_bucket(p.R, p.D)) {
    case 1:
      return decode_sweep::launch(paged_decode_kernel<T, C, 1, 4>, p, es,
                                  stream);
    case 2:
      return decode_sweep::launch(paged_decode_kernel<T, C, 2, 4>, p, es,
                                  stream);
    case 3:
      return decode_sweep::launch(paged_decode_kernel<T, C, 3, 4>, p, es,
                                  stream);
    case 4:
      return decode_sweep::launch(paged_decode_kernel<T, C, 4, 4>, p, es,
                                  stream);
    default:
      return decode_sweep::launch(paged_decode_kernel<T, C, 8, 4>, p, es,
                                  stream);
  }
}

bool bad_shape(int R, int D, int page, int block_s, int split, int Tlen) {
  return R < 1 || R > decode_sweep::kMaxR || D < 1 ||
         D > decode_sweep::kMaxD || page < 1 || block_s < page ||
         block_s % page != 0 || split < block_s || split % block_s != 0 ||
         Tlen % page != 0;
}

int dispatch(Params p, int dtype, bool quant, cudaStream_t st) {
  if (dtype == 0)
    return quant ? launch<float, int8_t>(p, st) : launch<float, float>(p, st);
  if (dtype == 1)
    return quant ? launch<__nv_bfloat16, int8_t>(p, st)
                 : launch<__nv_bfloat16, __nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q, the output and, here, the caches): 0 = float32,
// 1 = bfloat16.  R <= 16, D <= 256.  ws: (B * G * n_split, R, D + 2) f32
// partials (unused when n_split is 1); counters: >= B * G * n_hc int32
// zeros, left zero.
// n_split must be ceil(Tlen / split): the grid's third extent, which
// sized ws.  Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int paged_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* tables, const void* cache_len, void* out, void* ws,
    void* counters, int B, int Tlen, int G, int R, int D, int tw, int page,
    int block_s, int split, int n_split, float scale, int dtype,
    void* stream) {
  if (bad_shape(R, D, page, block_s, split, Tlen))
    return (int)cudaErrorInvalidValue;
  Params p{q,     k_cache, v_cache, nullptr, nullptr,
           static_cast<const int*>(tables), static_cast<const int*>(cache_len),
           out,   static_cast<float*>(ws), static_cast<int*>(counters),
           B,     Tlen,    G,       R,       D,
           tw,    page,    0,       split,   n_split,
           0,     scale};
  return dispatch(p, dtype, false, static_cast<cudaStream_t>(stream));
}

// The int8 pool: k_cache/v_cache int8 codes (B, Tlen, G, D), k_scale/
// v_scale f32 (B * Tlen / page, G); dtype is q's and the output's.
extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* cache_len, void* out, void* ws, void* counters, int B,
    int Tlen, int G, int R, int D, int tw, int page, int block_s, int split,
    int n_split, float scale, int dtype, void* stream) {
  if (bad_shape(R, D, page, block_s, split, Tlen))
    return (int)cudaErrorInvalidValue;
  Params p{q,     k_cache, v_cache, static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int*>(tables), static_cast<const int*>(cache_len),
           out,   static_cast<float*>(ws), static_cast<int*>(counters),
           B,     Tlen,    G,       R,       D,
           tw,    page,    0,       split,   n_split,
           0,     scale};
  return dispatch(p, dtype, true, static_cast<cudaStream_t>(stream));
}
