// Block-table gathers of the paged KV pool for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_gather.py::_gather_kernel (the
// Pallas kernel that paged_gather_pallas launches at :109) and
// ::_dequant_gather_kernel (paged_dequant_gather_pallas, :197).
//
// Both materialise a request-logical view of the pool: for pool row b
// and logical page j, the physical page
//   pid = max(table[b, j], 0)  ->  flat block (pid % B) * nb + pid / B
// of the (B * nb, page, G, D) view of the (B, T, G, D) cache is copied to
// flat block b * nb + j of the output.  Unmapped (-1) entries clamp to
// block 0, as the JAX reference does: the view then holds block 0's data
// there (the decode that reads the view masks it by cache length).
//
//   paged_gather           a copy of each page, dtype-agnostic and
//                          bit-exact;
//   paged_dequant_gather   int8 codes -> out dtype, each value times its
//                          page's scale for its KV group, scales
//                          (B * nb, G) f32 indexed by the same flat
//                          block.  For a bf16 output the scale is
//                          rounded to bf16 first and the product (exact
//                          in f32: two 8-bit significands) rounded once,
//                          which is what the JAX reference's bf16
//                          multiply gives.
//
// Bound on the H100: bytes.  Every page of the table is read once and
// the view written once: B * T * G * D * (in + out) bytes (plus the
// scales), over 3.35 TB/s.  No arithmetic to speak of.  What sets the
// time is how many bytes are in flight: at the serving shape (one cache
// of smollm-135m's pool, 3 MB each way) the whole view has to be in
// flight at once to come near a launch's floor.
//
// Design, against that bound.  The view is cut into items, each one
// copy unit: for the copy the widest of 16, 8, 4, 2 or 1 bytes that
// divides the page's bytes and both pointers; for the dequant gather the
// codes behind one 16-byte store, 8 for a bf16 output (an 8-byte load)
// and 4 for f32 (a char4), where D is a multiple of them and the codes'
// pointer lies on them, else 4 codes (one 8-byte bf16 store), else one.
// The plan (core/mapper.py::plan_gather, Eq. 1 over the items and hp)
// gives each thread lws items at a stride of the grid's threads, so a
// warp's items are neighbouring addresses of the view (coalesced loads
// and stores, each instruction dense) and, pages being whole multiples
// of items, mostly of one physical page (one table entry: an L1
// broadcast).  A thread takes its items in batches of four: their table
// entries, then all four loads, then the stores; at lws 1 (the serving
// shape: 196,608 vectors, under hp) every item of the view is in flight
// in one wave.  The item -> (page, offset) map is 32-bit, by
// multiply-and-shift division (FastDiv) by the page's items, nb and B,
// wherever the launch's threads x lws stay under 2^31; 64-bit
// otherwise.  A dequant item lies in one (position, group) row of D
// codes, so it takes one scale, group (k / (D / width)) % G of its
// page's G for item k of the page: no division per element.
//
// The dequant item follows the store, not the load: an item of 16
// codes (one 16-byte load) would leave its 32 or 64 output bytes as two
// or four 16-byte stores, each store instruction of a warp half (bf16)
// or a quarter (f32) dense.
//
// Measured on the H100 (tools/gather_probe.py, PERF.md): a TMA bulk
// copy (cp.async.bulk global -> shared -> global, one thread issuing
// whole pages against an mbarrier) reads within 2% of this route
// at both shapes: a little ahead of Eq. 1's single round, whose last
// DRAM round trip is exposed, and level with a plan of more, shorter
// CTAs (lws 4).  It takes only 16-byte pages and pointers, so the copy
// keeps this route and the lws is the tuner's to refine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // core/mapper.py GATHER_THREADS
constexpr int kBatch = 4;       // items a thread loads before it stores

// n / d for 0 <= n < 2^31 by a multiply and a shift: with s =
// ceil(log2 d) and m = floor(2^32 (2^s - d) / d) + 1, the quotient is
// (umulhi(n, m) + n) >> s (its error term stays under 1 / d there).
struct FastDiv {
  unsigned m, s;
  __device__ __forceinline__ unsigned operator()(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

FastDiv fast_div(unsigned d) {  // d >= 1
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  return {static_cast<unsigned>((((1ull << s) - d) << 32) / d + 1), s};
}

__device__ __forceinline__ int item_div(int i, int, FastDiv f) {
  return static_cast<int>(f(static_cast<unsigned>(i)));
}
__device__ __forceinline__ long long item_div(long long i, long long ipp,
                                              FastDiv) {
  return i / ipp;
}

// logical page p = b * nb + j -> its physical flat block
struct PageMap {
  const int* tables;
  int B, nb, tw;
  FastDiv div_nb, div_b;
  __device__ __forceinline__ int block(int p) const {
    const int b = static_cast<int>(div_nb(static_cast<unsigned>(p)));
    const int pid = max(__ldg(tables + b * tw + (p - b * nb)), 0);
    const int q = static_cast<int>(div_b(static_cast<unsigned>(pid)));
    return (pid - q * B) * nb + q;
  }
};

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const V* __restrict__ cache, V* __restrict__ out, PageMap map,
              I gws, I ipp, FastDiv div_ipp, int lws) {
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  const I t = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  for (int j0 = 0; j0 < lws; j0 += kBatch) {
    V v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j0 + u >= lws) break;
      const I i = t + static_cast<I>(j0 + u) * stride;
      if (i < gws) {
        const I p = item_div(i, ipp, div_ipp);
        v[u] = __ldg(cache + static_cast<I>(map.block(static_cast<int>(p)))
                                 * ipp + (i - p * ipp));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j0 + u >= lws) break;
      const I i = t + static_cast<I>(j0 + u) * stride;
      if (i < gws) out[i] = v[u];
    }
  }
}

// the dequant gather's item of W codes, as it is loaded
template <int W> struct CodeVec;
template <> struct CodeVec<8> { using type = uint2; };
template <> struct CodeVec<4> { using type = int; };   // a char4
template <> struct CodeVec<1> { using type = signed char; };

// signed byte k of w, widened
__device__ __forceinline__ float code(unsigned w, int k) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
}
__device__ __forceinline__ void widen(uint2 x, float (&f)[8]) {
  const unsigned w[2] = {x.x, x.y};
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = code(w[e / 4], e % 4);
}
__device__ __forceinline__ void widen(int x, float (&f)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = code(static_cast<unsigned>(x), e);
}
__device__ __forceinline__ void widen(signed char x, float (&f)[1]) {
  f[0] = static_cast<float>(x);
}

__device__ __forceinline__ float round_scale(float s, float*) { return s; }
__device__ __forceinline__ float round_scale(float s, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(s));
}

__device__ __forceinline__ unsigned pack(float a, float b) {  // a low
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

// W outputs as one store: 16 bytes (f32 W 4, bf16 W 8), 8 bytes (bf16
// W 4) or one value
template <int W>
__device__ __forceinline__ void store(float* o, const float (&f)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    o[0] = f[0];
  }
}
template <int W>
__device__ __forceinline__ void store(__nv_bfloat16* o, const float (&f)[W]) {
  if constexpr (W == 8) {
    *reinterpret_cast<uint4*>(o) =
        make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                   pack(f[6], f[7]));
  } else if constexpr (W == 4) {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(pack(f[0], f[1]), pack(f[2], f[3]));
  } else {
    o[0] = __float2bfloat16(f[0]);
  }
}

template <int W, typename T, typename I>
__global__ void __launch_bounds__(kThreads)
dequant_gather_kernel(const typename CodeVec<W>::type* __restrict__ codes,
                      const float* __restrict__ scale,  // (B * nb, G)
                      T* __restrict__ out, PageMap map, I gws, I ipp,
                      FastDiv div_ipp, FastDiv div_row, FastDiv div_g, int G,
                      int lws) {
  using C = typename CodeVec<W>::type;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  const I t = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  for (int j0 = 0; j0 < lws; j0 += kBatch) {
    C x[kBatch];
    float s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j0 + u >= lws) break;
      const I i = t + static_cast<I>(j0 + u) * stride;
      if (i < gws) {
        const I p = item_div(i, ipp, div_ipp);
        const int k = static_cast<int>(i - p * ipp);   // item of the page
        const int r = static_cast<int>(div_row(static_cast<unsigned>(k)));
        const int g =
            r - G * static_cast<int>(div_g(static_cast<unsigned>(r)));
        const int blk = map.block(static_cast<int>(p));
        x[u] = __ldg(codes + static_cast<I>(blk) * ipp + k);
        s[u] = round_scale(__ldg(scale + blk * G + g), out);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j0 + u >= lws) break;
      const I i = t + static_cast<I>(j0 + u) * stride;
      if (i < gws) {
        float f[W];
        widen(x[u], f);
#pragma unroll
        for (int e = 0; e < W; ++e) f[e] *= s[u];
        store<W>(out + static_cast<long long>(i) * W, f);  // outputs
      }
    }
  }
}

bool narrow(int grid, int lws) {  // every thread's items under 2^31
  return static_cast<long long>(grid) * kThreads * lws < (1LL << 31);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename V>
int launch_gather(const void* cache, void* out, const PageMap& map,
                  long long gws, long long ipp, int lws, int grid,
                  cudaStream_t st) {
  const V* c = static_cast<const V*>(cache);
  V* o = static_cast<V*>(out);
  if (narrow(grid, lws))
    gather_kernel<V, int><<<grid, kThreads, 0, st>>>(
        c, o, map, static_cast<int>(gws), static_cast<int>(ipp),
        fast_div(static_cast<unsigned>(ipp)), lws);
  else
    gather_kernel<V, long long><<<grid, kThreads, 0, st>>>(
        c, o, map, gws, ipp, FastDiv{0, 0}, lws);
  return (int)cudaGetLastError();
}

template <int W, typename T>
int launch_dequant(const void* codes, const float* scale, void* out,
                   const PageMap& map, long long gws, long long ipp, int D,
                   int G, int lws, int grid, cudaStream_t st) {
  using C = typename CodeVec<W>::type;
  const C* c = static_cast<const C*>(codes);
  T* o = static_cast<T*>(out);
  const FastDiv row = fast_div(D / W), grp = fast_div(G);
  if (narrow(grid, lws))
    dequant_gather_kernel<W, T, int><<<grid, kThreads, 0, st>>>(
        c, scale, o, map, static_cast<int>(gws), static_cast<int>(ipp),
        fast_div(static_cast<unsigned>(ipp)), row, grp, G, lws);
  else
    dequant_gather_kernel<W, T, long long><<<grid, kThreads, 0, st>>>(
        c, scale, o, map, gws, ipp, FastDiv{0, 0}, row, grp, G, lws);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dequant_width(int width, const void* codes, const float* scale,
                         void* out, const PageMap& map, long long gws,
                         long long ipp, int D, int G, int lws, int grid,
                         cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (width == 8)
      return launch_dequant<8, T>(codes, scale, out, map, gws, ipp, D, G,
                                  lws, grid, st);
  }
  if (width == 4)
    return launch_dequant<4, T>(codes, scale, out, map, gws, ipp, D, G, lws,
                                grid, st);
  return launch_dequant<1, T>(codes, scale, out, map, gws, ipp, D, G, lws,
                              grid, st);
}

// the checks both entries share: the pool's pages and its table
bool pool_ok(int B, int nb, int tw) {
  return B >= 1 && nb >= 1 && tw >= nb &&
         static_cast<long long>(B) * tw < (1LL << 31);
}

PageMap page_map(const void* tables, int B, int nb, int tw) {
  return {static_cast<const int*>(tables), B, nb, tw,
          fast_div(static_cast<unsigned>(nb)),
          fast_div(static_cast<unsigned>(B))};
}

}  // namespace

// cache (B, nb * page, ...) of page_bytes a page; tables (B, tw) int32;
// out like cache.  The plan (core/mapper.py::plan_gather): items of
// width bytes (16, 8, 4, 2 or 1, dividing page_bytes and both
// pointers), lws a thread over grid CTAs of 256 threads.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int paged_gather(const void* cache, const void* tables, void* out,
                            int B, int nb, int tw, long long page_bytes,
                            int width, int lws, int grid, void* stream) {
  if (!pool_ok(B, nb, tw) || page_bytes < 1 || lws < 1 || grid < 1 ||
      (width != 16 && width != 8 && width != 4 && width != 2 && width != 1) ||
      page_bytes % width || !aligned(cache, width) || !aligned(out, width))
    return (int)cudaErrorInvalidValue;
  const long long ipp = page_bytes / width;
  const long long gws = static_cast<long long>(B) * nb * ipp;
  if (static_cast<long long>(grid) * kThreads * lws < gws)
    return (int)cudaErrorInvalidValue;
  const PageMap map = page_map(tables, B, nb, tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16:
      return launch_gather<uint4>(cache, out, map, gws, ipp, lws, grid, st);
    case 8:
      return launch_gather<uint2>(cache, out, map, gws, ipp, lws, grid, st);
    case 4:
      return launch_gather<unsigned>(cache, out, map, gws, ipp, lws, grid,
                                     st);
    case 2:
      return launch_gather<unsigned short>(cache, out, map, gws, ipp, lws,
                                           grid, st);
    default:
      return launch_gather<unsigned char>(cache, out, map, gws, ipp, lws,
                                          grid, st);
  }
}

// codes (B, nb * page, G, D) int8; scale (B * nb, G) f32; tables (B, tw)
// int32; out (B, nb * page, G, D) in out_dtype (0 = float32, 1 =
// bfloat16).  Items of width codes: the codes behind one 16-byte store
// or fewer, 8 (bf16 only) or 4 (D a multiple of them, codes on them, out
// on the item's output bytes) or 1; lws a thread over grid CTAs of 256
// threads.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_dequant_gather(const void* codes, const void* scale,
                                    const void* tables, void* out, int B,
                                    int nb, int tw, int page, int G, int D,
                                    int width, int lws, int grid,
                                    int out_dtype, void* stream) {
  const int es = out_dtype == 0 ? 4 : 2;
  if (!pool_ok(B, nb, tw) || page < 1 || G < 1 || D < 1 || lws < 1 ||
      grid < 1 || (out_dtype != 0 && out_dtype != 1) ||
      (width != 8 && width != 4 && width != 1) || width * es > 16 ||
      D % width || !aligned(codes, width) || !aligned(out, width * es) ||
      static_cast<long long>(B) * nb * G >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long ipp = static_cast<long long>(page) * G * (D / width);
  const long long gws = static_cast<long long>(B) * nb * ipp;
  if (ipp >= (1LL << 31) ||
      static_cast<long long>(grid) * kThreads * lws < gws)
    return (int)cudaErrorInvalidValue;
  const PageMap map = page_map(tables, B, nb, tw);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch_dequant_width<float>(width, codes, sc, out, map, gws, ipp,
                                       D, G, lws, grid, st);
  return launch_dequant_width<__nv_bfloat16>(width, codes, sc, out, map, gws,
                                             ipp, D, G, lws, grid, st);
}
