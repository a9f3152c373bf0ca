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
//   paged_gather           a byte copy of each page, dtype-agnostic and
//                          bit-exact;
//   paged_dequant_gather   int8 codes -> out dtype, each value times its
//                          page's scale for its KV group, scales
//                          (B * nb, G) f32 indexed by the same flat
//                          block; the group of element e of a page is
//                          (e / D) % G.  For a bf16 output the scale is
//                          rounded to bf16 first and the product (exact
//                          in f32: two 8-bit significands) rounded once,
//                          which is what the JAX reference's bf16
//                          multiply gives.
//
// Bound on the H100: bytes.  Every page of the table is read once and
// the view written once: B * T * G * D * (in + out) bytes (plus the
// scales), over 3.35 TB/s.  No arithmetic to speak of.
//
// Design, against that bound: grid (nb, B), one CTA of 128 threads per
// (row, logical page); a page is contiguous (page * G * D elements), so
// the copy moves it with 16-byte loads and stores (uint4) whenever the
// page's bytes and both base pointers allow it, and byte by byte
// otherwise.  The dequant gather reads four codes (char4) at a time when
// D is a multiple of 4, so the four share one scale.  Left for later
// work: several pages per CTA (the serving shape's 512 CTAs of 6 KB each
// are short-lived), TMA bulk copies, and not materialising the view at
// all (which is what the fused paged decode does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ size_t src_block(const int* __restrict__ tables,
                                            int b, int j, int tw, int B,
                                            int nb) {
  const int pid = max(tables[(size_t)b * tw + j], 0);
  return (size_t)(pid % B) * nb + pid / B;
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const unsigned char* __restrict__ cache,
              const int* __restrict__ tables, unsigned char* __restrict__ out,
              int B, int nb, int tw, size_t page_bytes, int vec16) {
  const int j = blockIdx.x, b = blockIdx.y;
  const size_t src = src_block(tables, b, j, tw, B, nb) * page_bytes;
  const size_t dst = ((size_t)b * nb + j) * page_bytes;
  if (vec16) {
    const uint4* s = reinterpret_cast<const uint4*>(cache + src);
    uint4* o = reinterpret_cast<uint4*>(out + dst);
    for (size_t i = threadIdx.x; i < page_bytes / 16; i += kThreads)
      o[i] = s[i];
  } else {
    for (size_t i = threadIdx.x; i < page_bytes; i += kThreads)
      out[dst + i] = cache[src + i];
  }
}

__device__ __forceinline__ float round_scale(float s, float*) { return s; }
__device__ __forceinline__ float round_scale(float s, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(s));
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_gather_kernel(const int8_t* __restrict__ codes,
                      const float* __restrict__ scale,  // (B * nb, G)
                      const int* __restrict__ tables, T* __restrict__ out,
                      int B, int nb, int tw, int page, int G, int D,
                      int vec4) {
  const int j = blockIdx.x, b = blockIdx.y;
  const size_t blk = src_block(tables, b, j, tw, B, nb);
  const int n = page * G * D;
  const int8_t* c = codes + blk * n;
  const float* sc = scale + blk * G;
  T* o = out + ((size_t)b * nb + j) * n;
  if (vec4) {
    const char4* c4 = reinterpret_cast<const char4*>(c);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      const int e = 4 * i;
      const float s = round_scale(sc[(e / D) % G], o);
      const char4 x = c4[i];
      put(o + e, static_cast<float>(x.x) * s);
      put(o + e + 1, static_cast<float>(x.y) * s);
      put(o + e + 2, static_cast<float>(x.z) * s);
      put(o + e + 3, static_cast<float>(x.w) * s);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads)
      put(o + e, static_cast<float>(c[e]) * round_scale(sc[(e / D) % G], o));
  }
}

}  // namespace

// cache (B, Tlen, ...) of elem_bytes-wide elements, row_elems elements
// per position; tables (B, tw) int32; out like cache.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int paged_gather(const void* cache, const void* tables, void* out,
                            int B, int Tlen, int page, int row_elems,
                            int elem_bytes, int tw, void* stream) {
  if (B < 1 || page < 1 || Tlen % page != 0 || tw < Tlen / page ||
      row_elems < 1 || elem_bytes < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = Tlen / page;
  if (nb == 0) return 0;
  const size_t page_bytes = (size_t)page * row_elems * elem_bytes;
  const int vec16 = page_bytes % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gather_kernel<<<dim3(nb, B), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(cache),
      static_cast<const int*>(tables), static_cast<unsigned char*>(out), B,
      nb, tw, page_bytes, vec16);
  return (int)cudaGetLastError();
}

// codes (B, Tlen, G, D) int8; scale (B * Tlen / page, G) f32; tables
// (B, tw) int32; out (B, Tlen, G, D) in out_dtype (0 = float32,
// 1 = bfloat16).
extern "C" int paged_dequant_gather(const void* codes, const void* scale,
                                    const void* tables, void* out, int B,
                                    int Tlen, int page, int G, int D, int tw,
                                    int out_dtype, void* stream) {
  if (B < 1 || page < 1 || Tlen % page != 0 || tw < Tlen / page || G < 1 ||
      D < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = Tlen / page;
  if (nb == 0) return 0;
  const int vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  const dim3 grid(nb, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    dequant_gather_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
        static_cast<const int*>(tables), static_cast<float*>(out), B, nb, tw,
        page, G, D, vec4);
  else if (out_dtype == 1)
    dequant_gather_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
        static_cast<const int*>(tables), static_cast<__nv_bfloat16*>(out), B,
        nb, tw, page, G, D, vec4);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
