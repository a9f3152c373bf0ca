// Mamba-2 chunked SSD (state-space duality) for Hopper (sm_90a): three
// launches spread over (chunk, head), the products on the tensor cores.
//
// Replaces: src/repro/kernels/ssd.py::_ssd_kernel (the Pallas kernel that
// ssd_pallas_single launches at :67, vmapped over heads by ssd_pallas).
//
// The chunked SSD, per head h and chunk k of c steps (cum = cumsum of the
// chunk's log-decay a, total_k = cum[c - 1], S_in,0 = 0):
//   y = ((C B^T) o tril(exp(cum_t - cum_s))) X + (C o exp(cum)) S_in,k
//   S_in,k+1 = exp(total_k) S_in,k + (B o exp(total_k - cum))^T X
// x (L, H, P), b, c (L, G, N) and out (L, H, P) in one dtype (f32 or
// bf16); a (L, H) f32; head h reads group h / (H / G) (no repeated copy
// of b and c).  The decays and the states are f32 in both dtypes.
//
// Bound on the H100: operations, on the tensor cores.  The least count
// is the recurrence's (chunk 1), L H (2(N + P) + 4NP) FLOPs; every
// product but C B^T has an f32 operand.  In f32 each product counts as
// three TF32 products: ~0.026 ms at mamba2-1.3b's layer (L 2048, H 64,
// P 64, N 128) against ~0.021 ms for the bytes.  In bf16 the other
// operand of each f32-operand product is a bf16 input, exact in TF32, so
// two suffice: ~0.017 ms against ~0.010 ms for the bytes
// (chip_smoke.py::ssd_bound).
//
// Design.  The TPU walks a head's chunks in order, carrying the state in
// VMEM across its sequential grid; on Hopper that is H CTAs on 132 SMs.
// The chunked form splits into parts independent across (chunk, head) and
// a short scan that is elementwise over (H, N, P):
//  1. ssd_states, grid (chunks, H): the chunk's cum and total_k, and its
//     state contribution dS_k = (B o exp(total_k - cum))^T X, an (N, P)
//     product over the chunk's steps, written with total_k to an f32
//     workspace (chunks, H, N, P) that the wrapper allocates.
//  2. ssd_pass, grid (N P / 1024, H): each thread walks four (n, p)
//     elements through k = 0 .. chunks - 1 and replaces dS_k in place by
//     the state entering chunk k, S_in,k+1 = exp(total_k) S_in,k + dS_k;
//     bound by memory.
//  3. ssd_outputs, grid (chunks x 64-row tiles of the chunk, H): a CTA
//     takes 64 rows t of one chunk; y = exp(cum_t) (C S_in,k) first, then
//     for each 64-row tile of s at or below the diagonal the scores C B^T,
//     masked and decayed into shared memory, times X.  S_in shares its
//     shared memory with the later B, X and score tiles.
// Every product runs on mma.sync.m16n8k8 TF32 from shared memory, eight
// warps each taking a 16- or 32-row by 32-column block of the output.  An
// f32 operand is split into TF32 halves, big = its TF32 rounding
// (csrc/tf32_split.cuh's), small = the exact rest, whose low 13 bits the
// tensor cores drop, and the product is three TF32 products, small ones
// first (3xTF32, about 21 bits of each operand); a bf16 input is exact in
// TF32, so a product with one bf16 operand takes two and C B^T on bf16
// inputs one, exact per product.  The split is taken as each fragment is
// loaded (its instructions, not the tensor cores, set the products' time).
// The products of each 32-deep K step go to a fresh partial that is added
// to the f32 sum on the CUDA cores (the tensor cores' truncating sum
// stays short).  Tiles are staged as f32 (16-byte loads where the rows
// allow, all of a thread's loads issued before its stores) with zero
// padding past N, P and the chunk, in row strides that put each fragment
// load on 32 banks.  A chunk of any length 1..512 works: its rows past c
// are zero in the staged tiles and never stored.  The causal mask selects
// before the exponent: exp(cum_t - cum_s) is evaluated only for s <= t.
// The kernel takes L % chunk == 0 (the wrapper halves the chunk first).
// Next lever, if the workspace traffic sets the time: one launch as a
// chained scan, each CTA publishing its chunk's state after its
// predecessor's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 128;          // state width N
constexpr int kMaxP = 64;           // head width P
constexpr int kRows = 64;           // rows of a staged tile of t or s
constexpr int kStep = 32;           // K depth of one partial
// row strides (floats) of the staged tiles: a fragment's 32 loads fall on
// 32 banks when a tile read along its rows has a stride of 4 mod 8, and
// one read across its rows a stride of 8 mod 32
constexpr int kBN = kMaxN + 4;      // C, B rows [t or s][n]
constexpr int kBT = kMaxN + 8;      // step 1's B o w [s][n], read as (n, s)
constexpr int kXP = kMaxP + 8;      // X [s][p], S_in [n][p]
constexpr int kSS = kRows + 4;      // scores [t][s]
constexpr int kPassElems = 4;       // elements a pass thread walks
constexpr int kPassBatch = 8;       // chunks a pass thread loads at once

// shared-memory floats before the chunk-long arrays
constexpr int kStatesFloats = kRows * kBT + kRows * kXP;
constexpr int kRegionFloats = kRows * (kBN + kXP + kSS);  // >= kMaxN * kXP
constexpr int kOutputsFloats = kRows * kBN + kRegionFloats;
static_assert(kRegionFloats >= kMaxN * kXP, "S_in must fit the region");

template <typename T>
constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// c (16 x 8, f32) += a (16 x 8, row, tf32) b (8 x 8, col, tf32)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// big and small TF32 halves of v (about 21 of its 24 bits); an exact
// operand (a bf16 input) is its own big half
template <bool kIsExact>
__device__ __forceinline__ void halves(float v, uint32_t& big,
                                       uint32_t& small) {
  if (kIsExact) {
    big = __float_as_uint(v);
    small = 0u;
  } else {
    // big: v rounded to TF32; small: the rest, exact in f32, whose low
    // 13 bits the tensor cores drop; 0 where v (or big) is not finite
    const float hi = tf32_split::tf32_rna(v), lo = v - hi;
    big = __float_as_uint(hi);
    small = fabsf(lo) < INFINITY ? __float_as_uint(lo) : 0u;
  }
}

// One warp: acc[i][j] (the 16 x 8 tile at rows 16 i, columns 8 j) +=
// sum over k in [0, K) of A(m, k) B(k, n), with A(m, k) = a[m am + k ak]
// and B(k, n) = b[k bk + n bn] in shared memory (K a multiple of 8, the
// tiles zero past their data).  Each kStep of K goes to a fresh partial,
// then to acc.  kExactA / kExactB: that operand is exact in TF32.
template <int MT, int NT, bool kExactA, bool kExactB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const float* a, int am, int ak,
                                         const float* b, int bk, int bn,
                                         int K) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  for (int k0 = 0; k0 < K; k0 += kStep) {
    float part[MT][NT][4] = {};
    const int k1 = min(k0 + kStep, K);
    for (int k = k0; k < k1; k += 8) {
      uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 16 * i + g + 8 * (e & 1), kk = k + q + 4 * (e >> 1);
          halves<kExactA>(a[m * am + kk * ak], ab[i][e], as[i][e]);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = k + q + 4 * e, n = 8 * j + g;
          halves<kExactB>(b[kk * bk + n * bn], bb[j][e], bs[j][e]);
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (!kExactA) mma_tf32(part[i][j], as[i], bb[j]);
          if (!kExactB) mma_tf32(part[i][j], ab[i], bs[j]);
          mma_tf32(part[i][j], ab[i], bb[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
}

__device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }

// cum[t] = a[0] + ... + a[t] for t < len (a's steps `stride` apart):
// warp 0, each lane a run of steps, then a shuffle scan; ends synced
__device__ void cumsum(const float* __restrict__ a, int stride, int len,
                       float* cum) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (len + 31) / 32;
    const int beg = min(lane * per, len), end = min(beg + per, len);
    float run = 0.f;
    for (int t = beg; t < end; ++t) {
      run += a[(long long)t * stride];
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
}

__device__ __forceinline__ bool on16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Stage a kTileRows x kCols tile into dst (row stride ld floats): source
// row r < rows starts at src + r * stride and holds `width` elements,
// each times w[r] when w is given; zero past `rows` and `width`.  With
// `vec` (width and stride whole 16-byte vectors, src on 16 bytes) each
// thread issues all its 16-byte loads before its first store; else one
// element a thread at a time.
template <typename T, int kTileRows, int kCols>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src,
                                      long long stride, int rows, int width,
                                      const float* w, bool vec) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kRowVecs = kCols / kV;
  constexpr int kPer = kTileRows * kRowVecs / kThreads;
  static_assert(kTileRows * kRowVecs % kThreads == 0, "whole vectors");
  if (vec) {
    uint4 buf[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / kRowVecs, c = i % kRowVecs * kV;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < width)
        buf[u] = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / kRowVecs, c = i % kRowVecs * kV;
      const T* e = reinterpret_cast<const T*>(&buf[u]);
      const float sc = (w != nullptr && r < rows) ? w[r] : 1.f;
#pragma unroll
      for (int j = 0; j < kV; j += 4)
        *reinterpret_cast<float4*>(dst + r * ld + c + j) =
            make_float4(to_f32(e[j]) * sc, to_f32(e[j + 1]) * sc,
                        to_f32(e[j + 2]) * sc, to_f32(e[j + 3]) * sc);
    }
  } else {
    for (int i = threadIdx.x; i < kTileRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      float v = 0.f;
      if (r < rows && c < width) {
        v = to_f32(src[r * stride + c]);
        if (w != nullptr) v *= w[r];
      }
      dst[r * ld + c] = v;
    }
  }
}

// 1. dS_k = (B o exp(total_k - cum))^T X and total_k of chunk k, head h.
// Warp w owns rows n in 32 (w % 4) + [0, 32) and columns p in
// 32 (w / 4) + [0, 32) of dS.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_states(const T* __restrict__ x, const float* __restrict__ a,
           const T* __restrict__ b, float* __restrict__ ws,
           float* __restrict__ tot, int H, int G, int N, int P, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* Bw = smem;                       // kRows x kBT
  float* Xs = Bw + kRows * kBT;           // kRows x kXP
  float* cum = Xs + kRows * kXP;          // chunk
  float* w = cum + chunk;                 // chunk: exp(total - cum)
  const int k = blockIdx.x, h = blockIdx.y, g = h / (H / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long c0 = (long long)k * chunk;

  cumsum(a + c0 * H + h, H, chunk, cum);
  const float total = cum[chunk - 1];
  for (int t = threadIdx.x; t < chunk; t += kThreads)
    w[t] = expf(total - cum[t]);
  __syncthreads();

  const int rw = 32 * (warp % 4), cw = 32 * (warp / 4);
  const bool live = rw < N && cw < P;
  constexpr int kV = 16 / sizeof(T);
  const bool vec_b = N % kV == 0 && on16(b), vec_x = P % kV == 0 && on16(x);
  float acc[2][4][4] = {};
  for (int s0 = 0; s0 < chunk; s0 += kRows) {
    const int rows = min(kRows, chunk - s0);
    stage<T, kRows, kMaxN>(Bw, kBT, b + ((c0 + s0) * G + g) * N,
                           (long long)G * N, rows, N, w + s0, vec_b);
    stage<T, kRows, kMaxP>(Xs, kXP, x + ((c0 + s0) * H + h) * P,
                           (long long)H * P, rows, P, nullptr, vec_x);
    __syncthreads();
    // A(n, s) = Bw[s][n], B(s, p) = Xs[s][p]
    if (live)
      warp_mma<2, 4, false, kExact<T>>(acc, Bw + rw, 1, kBT, Xs + cw, kXP,
                                       1, round8(rows));
    __syncthreads();
  }

  float* out = ws + ((long long)k * H + h) * N * P;
  const int gq = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = rw + 16 * i + gq + 8 * (e >> 1);
        const int p = cw + 8 * j + 2 * q + (e & 1);
        if (n < N && p < P) out[n * P + p] = acc[i][j][e];
      }
  if (threadIdx.x == 0) tot[(long long)k * H + h] = total;
}

// 2. In place over the workspace: dS_k -> S_in,k, the state entering
// chunk k (S_in,0 = 0, S_in,k+1 = exp(total_k) S_in,k + dS_k); thread e
// of head h walks kPassElems (n, p) elements through every chunk, as one
// 16-byte vector where N P is a multiple of 4, issuing kPassBatch
// chunks' loads before their stores.
__global__ void __launch_bounds__(kThreads)
ssd_pass(float* __restrict__ ws, const float* __restrict__ tot, int chunks,
         int H, int NP) {
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * kPassElems;
  const int h = blockIdx.y;
  if (e0 >= NP) return;
  const long long step = (long long)H * NP;
  float* p = ws + (long long)h * NP + e0;
  const bool vec = NP % kPassElems == 0;
  float s[kPassElems] = {};
  for (int k0 = 0; k0 < chunks; k0 += kPassBatch) {
    float d[kPassBatch][kPassElems], decay[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      const int k = k0 + u;
      if (k >= chunks) continue;
      decay[u] = expf(tot[(long long)k * H + h]);
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(p + k * step);
        d[u][0] = v.x, d[u][1] = v.y, d[u][2] = v.z, d[u][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < kPassElems; ++i)
          d[u][i] = e0 + i < NP ? p[k * step + i] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      const int k = k0 + u;
      if (k >= chunks) continue;
      if (vec) {
        *reinterpret_cast<float4*>(p + k * step) =
            make_float4(s[0], s[1], s[2], s[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kPassElems; ++i)
          if (e0 + i < NP) p[k * step + i] = s[i];
      }
#pragma unroll
      for (int i = 0; i < kPassElems; ++i) s[i] = s[i] * decay[u] + d[u][i];
    }
  }
}

// 3. The outputs of rows t0 + [0, 64) of chunk k, head h.  Warp w owns
// rows 16 (w % 4) + [0, 16) and columns 32 (w / 4) + [0, 32) of the y
// tile and of each score tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_outputs(const T* __restrict__ x, const float* __restrict__ a,
            const T* __restrict__ b, const T* __restrict__ c,
            const float* __restrict__ ws, T* __restrict__ out, int H, int G,
            int N, int P, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                       // kRows x kBN
  float* Ss = Cs + kRows * kBN;           // kMaxN x kXP, then reused:
  float* Bs = Ss;                         //   kRows x kBN
  float* Xs = Bs + kRows * kBN;           //   kRows x kXP
  float* Sc = Xs + kRows * kXP;           //   kRows x kSS
  float* cum = Cs + kOutputsFloats;       // the chunk up to the tile's end
  const int tiles = (chunk + kRows - 1) / kRows;
  const int k = blockIdx.x / tiles, it = blockIdx.x % tiles;
  const int h = blockIdx.y, g = h / (H / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, q = lane % 4;
  const long long c0 = (long long)k * chunk;
  const int t0 = it * kRows, trows = min(kRows, chunk - t0);

  constexpr int kV = 16 / sizeof(T);
  const bool vec_bc = N % kV == 0 && on16(b) && on16(c);
  const bool vec_x = P % kV == 0 && on16(x);
  cumsum(a + c0 * H + h, H, t0 + trows, cum);
  stage<T, kRows, kMaxN>(Cs, kBN, c + ((c0 + t0) * G + g) * N,
                         (long long)G * N, trows, N, nullptr, vec_bc);
  const float* sin = ws + ((long long)k * H + h) * N * P;
  stage<float, kMaxN, kMaxP>(Ss, kXP, sin, P, N, P, nullptr,
                             P % 4 == 0 && on16(ws));
  __syncthreads();

  const int rw = 16 * (warp % 4), cw = 32 * (warp / 4);
  const bool rows_live = rw < trows;
  float acc[1][4][4] = {};
  if (rows_live && cw < P) {
    // C S_in: A(t, n) = Cs[t][n], B(n, p) = Ss[n][p]; then exp(cum_t)
    warp_mma<1, 4, kExact<T>, false>(acc, Cs + rw * kBN, kBN, 1, Ss + cw,
                                     kXP, 1, round8(N));
    const int ta = rw + gq, tb = ta + 8;
    float ea = 0.f, eb = 0.f;
    if (ta < trows) ea = expf(cum[t0 + ta]);
    if (tb < trows) eb = expf(cum[t0 + tb]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[0][j][0] *= ea;
      acc[0][j][1] *= ea;
      acc[0][j][2] *= eb;
      acc[0][j][3] *= eb;
    }
  }
  __syncthreads();                        // S_in's region is reused below

  for (int is = 0; is <= it; ++is) {
    const int s0 = is * kRows, srows = min(kRows, chunk - s0);
    stage<T, kRows, kMaxN>(Bs, kBN, b + ((c0 + s0) * G + g) * N,
                           (long long)G * N, srows, N, nullptr, vec_bc);
    stage<T, kRows, kMaxP>(Xs, kXP, x + ((c0 + s0) * H + h) * P,
                           (long long)H * P, srows, P, nullptr, vec_x);
    __syncthreads();
    // scores C B^T over this warp's 16 x 32 block: A(t, n) = Cs[t][n],
    // B(n, s) = Bs[s][n]; a block wholly above the diagonal is zero
    float sc[1][4][4] = {};
    if (rows_live && cw < srows && s0 + cw <= t0 + rw + 15)
      warp_mma<1, 4, kExact<T>, kExact<T>>(sc, Cs + rw * kBN, kBN, 1,
                                           Bs + cw * kBN, 1, kBN,
                                           round8(N));
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = rw + gq + 8 * (e >> 1);
        const int sl = cw + 8 * j + 2 * q + (e & 1);
        const int t = t0 + tl, s = s0 + sl;
        // select before the exponent: only s <= t is ever exponentiated
        float v = 0.f;
        if (tl < trows && sl < srows && s <= t)
          v = sc[0][j][e] * expf(cum[t] - cum[s]);
        Sc[tl * kSS + sl] = v;
      }
    __syncthreads();
    // y += scores X: A(t, s) = Sc[t][s], B(s, p) = Xs[s][p]; on the
    // diagonal tile the warp's rows need s up to rw + 15 only
    if (rows_live && cw < P) {
      const int kend = is == it ? min(srows, rw + 16) : srows;
      warp_mma<1, 4, false, kExact<T>>(acc, Sc + rw * kSS, kSS, 1, Xs + cw,
                                       kXP, 1, round8(kend));
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tl = rw + gq + 8 * (e >> 1), p = cw + 8 * j + 2 * q + (e & 1);
      if (tl < trows && p < P)
        store(out + ((c0 + t0 + tl) * H + h) * (long long)P + p,
              acc[0][j][e]);
    }
}

size_t smem_states(int chunk) {
  return sizeof(float) * ((size_t)kStatesFloats + 2 * (size_t)chunk);
}

size_t smem_outputs(int chunk) {
  return sizeof(float) * ((size_t)kOutputsFloats + (size_t)chunk);
}

int tiles_of(int chunk) { return (chunk + kRows - 1) / kRows; }

int pass_blocks(int np) {
  const int per = kThreads * kPassElems;
  return (np + per - 1) / per;
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           void* out, void* ws, void* tot, int L, int H, int G, int N, int P,
           int chunk, cudaStream_t stream) {
  const int chunks = L / chunk;
  const T* xt = static_cast<const T*>(x);
  const float* af = static_cast<const float*>(a);
  const T* bt = static_cast<const T*>(b);
  float* wsf = static_cast<float*>(ws);
  float* totf = static_cast<float*>(tot);
  size_t smem = smem_states(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_states<T><<<dim3(chunks, H), kThreads, smem, stream>>>(
      xt, af, bt, wsf, totf, H, G, N, P, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int np = N * P;
  ssd_pass<<<dim3(pass_blocks(np), H), kThreads, 0, stream>>>(
      wsf, totf, chunks, H, np);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smem = smem_outputs(chunk);
  err = cudaFuncSetAttribute(ssd_outputs<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_outputs<T><<<dim3(chunks * tiles_of(chunk), H), kThreads, smem,
                   stream>>>(xt, af, bt, static_cast<const T*>(c), wsf,
                             static_cast<T*>(out), H, G, N, P, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int step, int chunk, int* blocks) {
  if (step == 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ssd_pass, kThreads, 0);
  const void* fn = step == 0 ? (const void*)ssd_states<T>
                             : (const void*)ssd_outputs<T>;
  const size_t smem = step == 0 ? smem_states(chunk) : smem_outputs(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                           kThreads, smem);
}

}  // namespace

// The SSD's three launches (states, pass, outputs) on one stream.  ws:
// f32 (L / chunk, H, N, P), tot: f32 (L / chunk, H), both written by the
// states step and read by the later steps; dtype of x, b, c and out:
// 0 = float32, 1 = bfloat16.  grids (6 ints) receives the (x, y) extent
// of each step's grid, in launch order.  Returns cudaGetLastError()
// after the last launch (0 on success).
extern "C" int ssd(const void* x, const void* a, const void* b, const void* c,
                   void* out, void* ws, void* tot, int L, int H, int G, int N,
                   int P, int chunk, int dtype, void* stream, int* grids) {
  if (L < 1 || H < 1 || G < 1 || H % G || N < 1 || N > kMaxN || P < 1 ||
      P > kMaxP || chunk < 1 || L % chunk || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int launched[6] = {L / chunk, H, pass_blocks(N * P), H,
                           L / chunk * tiles_of(chunk), H};
  for (int i = 0; i < 6; ++i) grids[i] = launched[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, a, b, c, out, ws, tot, L, H, G, N, P, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, c, out, ws, tot, L, H, G, N, P,
                                 chunk, st);
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM that the CUDA runtime reports for step `step`
// (0 states, 1 pass, 2 outputs) at this chunk length.
extern "C" int ssd_occupancy(int step, int chunk, int dtype, int* blocks) {
  if (step < 0 || step > 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return occupancy<float>(step, chunk, blocks);
  if (dtype == 1) return occupancy<__nv_bfloat16>(step, chunk, blocks);
  return (int)cudaErrorInvalidValue;
}
