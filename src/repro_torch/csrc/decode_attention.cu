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
// smollm-135m's width), far below the ~295 FLOP/byte ridge.  At the
// serving shape that is under a microsecond, so what bounds the kernel
// in practice is latency: the chain of dependent loads one CTA walks.
//
// Design, against that: the split-KV sweep of csrc/decode_sweep.cuh.
// The grid is (B, G, n_split): each row is cut into splits of W
// positions (the mapper's Eq. 1 plan over the resident CTA slots, a
// whole number of block_s), so the SMs share a long row instead of one
// CTA walking it; within a split the group's K/V rows are staged once
// for all R query heads (the GQA reuse; the JAX kernel runs one
// instance per head and reads each group's cache R times) by cp.async
// into a 4-stage ring, and the partials of a row's splits are merged by
// its last split to finish.  cache_len is clamped to [0, T]: a retired
// slot's length keeps growing and may pass T; a row of length 0 writes
// zeros, not NaN.
//
// Launch geometry: grid (B, G, n_split), 128 threads, dynamic shared
// memory decode_sweep::smem_bytes(D, R, 0, dtype bytes), under
// 48 KB.  Inputs fp32 or bf16 (q and caches of one dtype); accumulation
// fp32; output in q's dtype.

#include "decode_sweep.cuh"

namespace {

using decode_sweep::Params;

template <typename T, int RB>
__global__ void __launch_bounds__(decode_sweep::kThreads,
                                  decode_sweep::kMinCtasPerSm)
decode_kernel(const Params p) {
  decode_sweep::sweep<T, T, false, RB>(p);
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  switch (decode_sweep::heads_bucket(p.R)) {
    case 1:
      return decode_sweep::launch(decode_kernel<T, 1>, p, sizeof(T), stream);
    case 2:
      return decode_sweep::launch(decode_kernel<T, 2>, p, sizeof(T), stream);
    case 3:
      return decode_sweep::launch(decode_kernel<T, 3>, p, sizeof(T), stream);
    case 4:
      return decode_sweep::launch(decode_kernel<T, 4>, p, sizeof(T), stream);
    default:
      return decode_sweep::launch(decode_kernel<T, 8>, p, sizeof(T), stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws: (B * G * n_split, R, D + 2)
// f32 partials (unused when n_split is 1); counters: >= B * G int32
// zeros, left zero.  n_split must be ceil(Tlen / split): the grid's
// third extent, which sized ws.  Returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for a shape or plan the
// kernel does not take.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* cache_len,
                                void* out, void* ws, void* counters, int B,
                                int Tlen, int G, int R, int D, int block_s,
                                int split, int n_split, float scale,
                                int dtype, void* stream) {
  if (R < 1 || R > decode_sweep::kMaxR || D < 1 || D > decode_sweep::kMaxD ||
      block_s < 1 || split < block_s || split % block_s != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q,       k_cache, v_cache, nullptr, nullptr,
           nullptr, static_cast<const int*>(cache_len), out,
           static_cast<float*>(ws), static_cast<int*>(counters),
           B,       Tlen,    G,       R,       D,
           0,       0,       0,       split,   n_split,
           0,       scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}
