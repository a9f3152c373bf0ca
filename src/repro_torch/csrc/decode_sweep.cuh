// The split-KV flash-decode sweep shared by the two decode kernels of the
// port (csrc/decode_attention.cu: contiguous rows; csrc/
// paged_decode_attention.cu: rows read through block tables, f32/bf16 or
// int8 codes).
//
// Launch geometry: grid (B, G * n_hc, n_split), 128 threads (4 warps).
// CTA (b, g n_hc + h, s) owns the h-th run of R / n_hc query heads of KV
// group g of row b (n_hc = 1, all R heads, for R <= 8 at D <= 128) over
// the positions [s W, min((s + 1) W, clen)) of the row, where W (the split,
// a whole number of the plan's block_s, so whole pages on the paged
// path) and n_split = ceil(T / W) come from the mapper's plan over the
// pool row's length T: the host never reads cache_len.  A split that
// starts at or past clen exits at once; with clen 0 split 0 writes zeros.
//
// Inside a split.  Positions are staged `chunk` at a time, in the cache's
// own dtype, by 16-byte cp.async into a ring of kStages stages, so the
// next chunks' loads are in flight while this chunk is scored; a chunk
// holds at most kStageBytes of K (and as many of V) and at most
// kMaxChunk positions.  A position's head_dim is spread over `lp` lanes
// (EPL values each: 4 up to D 128, 8 past it; lp the power of two
// covering D / EPL, at most a warp): every lane holds its EPL values of
// the CTA's pre-scaled queries in registers, and each group of lp lanes
// carries its own online softmax (m, l, acc of its EPL values) over the
// positions it takes (group i takes positions i,
// i + 128 / lp, ... of a chunk).  A group scores kPB positions at once:
// their loads, their R partial dots each, the xor-shuffle sums and the
// softmax update (one rescale for the batch) are independent, so the
// latency of one shuffle chain and one exp covers kPB positions.  Every
// warp scores and accumulates P.V; no integer division by runtime D or
// page size is left in the loop (the page walk of a thread keeps
// quotient and remainder by additions).  The paged layout resolves each
// page of a chunk once per CTA: one thread reads the table entry, forms
// the flat block (pid % B) * nb + pid / B of the column-major grid and,
// for int8, reads the page's two group scales into a page slot in shared
// memory; the thread staging a row's first unit copies its page's
// scales beside the row.
//
// Merge.  At the end the groups' (m, l, acc) are combined in shared
// memory: m* = max m_i, l = sum l_i e^(m_i - m*), acc = sum acc_i
// e^(m_i - m*) (across splits in batches of kMergeBatch partials, each
// batch's loads in flight together).  A row whose clen lies in one split writes
// acc / max(l, 1e-30) at once.  Otherwise each split writes its f32
// partial (m, l, acc) of the R heads to the workspace and takes a ticket
// on the (b, g) counter (atomicAdd after a fence); the last of the row's
// live splits merges the partials the same way, writes the output in
// q's dtype and resets the counter to 0.  So a call stays one launch;
// the workspace (from torch.empty) and the counters (zeroed) come from
// the wrapper, allocated once per device and stream and grown when a
// launch needs more.  The kernel allocates nothing and does not
// synchronise.
//
// A staged row holds ds = round_up(D, EPL) values; a lane whose EPL
// values start at or past ds (EPL lp > ds, e.g. D 96 or 100: lanes
// 24/25-31; D 192: lanes 24-31, a quarter of each warp idle) reads
// nothing, so no load leaves its row or the ring.
//
// Wide groups.  The registers a thread holds grow with the heads a CTA
// takes times EPL (query and accumulator: 2 RB EPL floats), so a CTA
// takes at most 8 heads at EPL 4 and 4 at EPL 8: R splits into n_hc runs
// of rh = R / n_hc heads, rh the largest divisor of R within that cap (R
// 12: two runs of 6 at D <= 128, three of 4 past it; R 16: two of 8, four
// of 4).  Each run is a CTA of its own that stages the group's K/V (the
// runs of one group are adjacent in the grid, so the repeats come from
// L2); in the kernel a run is a virtual group: q, out, the partials and
// the tickets are indexed as (B, G n_hc, rh, D), the caches and scales by
// the true group g.  The EPL 8 kernels are bound to 3 CTAs an SM (168
// registers), the others to 4.
//
// Dynamic shared memory: max(ring + page slots, merge area), at most
// ~36 KB, under the 48 KB a launch takes without an attribute:
//   ring   kStages * 2 * round_up(chunk * ds * es, 16)
//   pages  (kStages + 1) * ppc * 12 + kStages * chunk * 8
//          (paged only; ppc pages a chunk spans; then each staged row's
//          two scales)
//   merge  4 * rh * ng * (EPL lp + 2),   ng = 128 / lp groups
// (repro_torch.core.mapper.decode_smem_bytes mirrors it for the plan;
// smem_bytes() below is what the launch uses, and it refuses more than
// 48 KB.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace decode_sweep {

constexpr int kThreads = 128;
constexpr int kMaxR = 16;
constexpr int kMaxD = 256;
constexpr int kNarrowD = 128;       // up to it a lane holds 4 values, past 8
constexpr int kMaxRB = 8;           // heads a CTA takes at EPL 4
constexpr int kMaxRBWide = 4;       // heads a CTA takes at EPL 8
constexpr int kStages = 4;          // cp.async ring depth
constexpr int kStageBytes = 4096;   // K bytes of one stage, at most
constexpr int kMaxChunk = 32;       // positions of one stage, at most
constexpr int kMaxSmem = 48 * 1024; // dynamic smem without an attribute
constexpr int kMergeBatch = 16;     // partials a merging thread loads at once

// __launch_bounds__ minimum: 4 CTAs an SM (128 registers) at EPL 4, 3
// (168) at EPL 8
__host__ __device__ constexpr int min_ctas(int epl) { return epl > 4 ? 3 : 4; }

__host__ __device__ inline int round_up(int x, int q) {
  return (x + q - 1) / q * q;
}

// head_dim values a lane holds
__host__ __device__ inline int epl_of(int D) { return D > kNarrowD ? 8 : 4; }

// lanes a position's head_dim is spread over: a power of two, <= 32
__host__ __device__ inline int lanes_per_pos(int D) {
  const int epl = epl_of(D);
  int lp = 1;
  while (lp * epl < D) lp <<= 1;
  return lp;
}

// runs of heads a group's R query heads split into (see the header)
inline int head_chunks(int R, int D) {
  const int cap = D > kNarrowD ? kMaxRBWide : kMaxRB;
  int rh = R < cap ? R : cap;
  while (R % rh) --rh;
  return R / rh;
}

// positions staged per ring stage
__host__ __device__ inline int chunk_rows(int D, int es) {
  const int cap = kStageBytes / (round_up(D, epl_of(D)) * es);
  int rows = 1;
  while (rows * 2 <= cap && rows * 2 <= kMaxChunk) rows <<= 1;
  return rows;
}

__host__ __device__ inline int pages_per_chunk(int chunk, int page) {
  const int spanned = (chunk + page - 2) / page + 1;
  return spanned < chunk ? spanned : chunk;
}

__host__ __device__ inline int ring_bytes(int chunk, int D, int es) {
  return kStages * 2 * round_up(chunk * round_up(D, epl_of(D)) * es, 16);
}

// rh: the heads one CTA takes; page == 0: the contiguous layout (no page
// slots)
inline size_t smem_bytes(int D, int rh, int page, int es) {
  const int chunk = chunk_rows(D, es);
  const int pages = page > 0 ? (kStages + 1) * pages_per_chunk(chunk, page) *
                                       12 + kStages * chunk * 8
                             : 0;
  const int lp = lanes_per_pos(D);
  const int merge = 4 * rh * (kThreads / lp) * (epl_of(D) * lp + 2);
  const int staged = ring_bytes(chunk, D, es) + pages;
  return (size_t)(staged > merge ? staged : merge);
}

// Everything a launch passes: pointers of both layouts (the contiguous
// kernel leaves the paged ones null) and the plan.
struct Params {
  const void* q;          // (B, G, R, D), T
  const void* k;          // (B, Tlen, G, D), C
  const void* v;
  const float* k_scale;   // (B * nb, G), int8 only
  const float* v_scale;
  const int* tables;      // (B, tw), paged only
  const int* cache_len;   // (B,)
  void* out;              // (B, G, R, D), T
  float* ws;              // (B * G * n_split, R, D + 2) f32 partials
  int* counters;          // (>= B * G * n_hc,) tickets, 0 between launches
  int B, Tlen, G, R, D, tw, page, chunk, split, n_split, vec;
  float scale;
  int n_hc;               // runs of heads a group splits into
  int rh;                 // heads one CTA takes, R / n_hc
};

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

// EPL consecutive staged values as f32 (aligned: ds is a multiple of EPL)
__device__ __forceinline__ void loadv(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void loadv(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void loadv(const int8_t* p, float (&x)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void loadv(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void loadv(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void loadv(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const char4 a = *reinterpret_cast<const char4*>(&u.x);
  const char4 b = *reinterpret_cast<const char4*>(&u.y);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Walks i = i0, i0 + step, ... keeping q = i / m and r = i % m with one
// division at the start and additions after.
struct DivWalk {
  int q, r, dq, dr, m;
  __device__ __forceinline__ DivWalk(int i0, int step, int mod)
      : q(i0 / mod), r(i0 % mod), dq(step / mod), dr(step % mod), m(mod) {}
  __device__ __forceinline__ void next() {
    q += dq;
    r += dr;
    if (r >= m) {
      r -= m;
      ++q;
    }
  }
};

// The sweep of one (row, run of heads, split) CTA; see the header
// comment.  T: q/out dtype; C: cache dtype; RB sizes the register arrays:
// the CTA's heads themselves for up to 4 (so no head loop is guarded),
// kMaxRB for 5 to 8; EPL the head_dim values a lane holds (epl_of(D)).
template <typename T, typename C, bool kPaged, int RB, int EPL>
__device__ __forceinline__ void sweep(const Params& p) {
  constexpr bool kQuant = std::is_same<C, int8_t>::value;
  constexpr int es = sizeof(C);
  // positions a group scores at once
  constexpr int kPB = (RB > 4 || EPL > 4) ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const int b = blockIdx.x, gv = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x;
  // R: the CTA's heads; gv: its virtual group (see the header); g: the KV
  // group whose cache and scales it reads
  const int R = p.rh, D = p.D, G = p.G;
  const int g = gv / p.n_hc;
  const int bg = b * G * p.n_hc + gv;
  // positions that exist in the row: a retired slot's cache_len keeps
  // growing every tick and may pass the row; no read may leave it
  const int clen = max(0, min(p.cache_len[b], p.Tlen));
  const int lo = sp * p.split;
  T* out = static_cast<T*>(p.out) + (size_t)bg * R * D;
  if (lo >= clen) {
    if (sp == 0)  // clen 0: zeros, not NaN
      for (int o = tid; o < R * D; o += kThreads) store(out + o, 0.f);
    return;
  }
  const int hi = min(lo + p.split, clen);
  const int n_live = (clen + p.split - 1) / p.split;
  const int ds = round_up(D, EPL);
  const int lp = lanes_per_pos(D);
  const int lsh = __ffs(lp) - 1;
  const int ng = kThreads >> lsh;
  const int grp = tid >> lsh, j = tid & (lp - 1);
  const bool col_in = j * EPL < ds;   // the lane's values lie in the row
  const int chunk = p.chunk;
  const int tile = round_up(chunk * ds * es, 16) / es;   // elements
  C* ring = reinterpret_cast<C*>(smem);
  const int ppc = kPaged ? pages_per_chunk(chunk, p.page) : 1;
  int* s_blk = reinterpret_cast<int*>(smem + ring_bytes(chunk, D, es));
  float* s_ks = reinterpret_cast<float*>(s_blk + (kStages + 1) * ppc);
  float* s_vs = s_ks + (kStages + 1) * ppc;
  float* s_rk = s_vs + (kStages + 1) * ppc;   // (kStages, chunk) row scales
  float* s_rv = s_rk + kStages * chunk;

  // heads past R exist only when RB is kMaxRB
  auto live = [&](int r) { return RB < kMaxRB || r < R; };

  // the CTA's R queries, pre-scaled, EPL values a lane
  float qr[RB][EPL];
  const T* qp = static_cast<const T*>(p.q) + (size_t)bg * R * D;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = j * EPL + e;
      qr[r][e] = (r < R && d < D) ? to_f32(qp[r * D + d]) * p.scale : 0.f;
    }

  // staging: a unit is 16 bytes (vec) or one value; a thread copies the
  // same unit column of every rpp-th row
  const C* kc = static_cast<const C*>(p.k);
  const C* vc = static_cast<const C*>(p.v);
  const int vw = p.vec ? 16 / es : 1;
  const int upr = ds / vw;
  const int rpp = kThreads / upr;
  const bool issuer = tid < rpp * upr;
  const int ic = tid % upr, ir0 = tid / upr;
  const int col = ic * vw;
  const int nb = p.Tlen / (kPaged ? p.page : 1);
  const int n_chunks = (hi - lo + chunk - 1) / chunk;
  const int* trow = kPaged ? p.tables + (size_t)b * p.tw : nullptr;

  auto copy = [&](C* dst, const C* src) {
    if (p.vec) {
      cp_async16(dst, src);
    } else {  // one value; the row's padding past D stages zeros
      *dst = col < D ? *src : C{};
    }
  };
  // chunk c of the split: positions lo + c chunk ... into stage c % kStages
  auto issue = [&](int c) {
    const int s0r = c * chunk;
    const int n = min(chunk, hi - lo - s0r);
    C* sk = ring + (c % kStages) * 2 * tile;
    C* sv = sk + tile;
    if (!issuer) return;
    if constexpr (kPaged) {
      const int slot = (c % (kStages + 1)) * ppc;
      const int q0 = s0r / p.page;
      DivWalk w(s0r + ir0, rpp, p.page);
      for (int i = ir0; i < n; i += rpp, w.next()) {
        const size_t off =
            (((size_t)s_blk[slot + w.q - q0] * p.page + w.r) * G + g) * D +
            col;
        copy(sk + i * ds + col, kc + off);
        copy(sv + i * ds + col, vc + off);
        if constexpr (kQuant) {
          if (ic == 0) {
            const int row = (c % kStages) * chunk + i;
            s_rk[row] = s_ks[slot + w.q - q0];
            s_rv[row] = s_vs[slot + w.q - q0];
          }
        }
      }
    } else {
      const size_t row0 = (size_t)b * p.Tlen + lo + s0r;
      for (int i = ir0; i < n; i += rpp) {
        const size_t off = ((row0 + i) * G + g) * D + col;
        copy(sk + i * ds + col, kc + off);
        copy(sv + i * ds + col, vc + off);
      }
    }
  };
  // the pages of chunk c into page slot c % (kStages + 1), once per CTA
  auto resolve = [&](int c) {
    if constexpr (kPaged) {
      if (c >= n_chunks) return;
      const int s0r = c * chunk;
      const int n = min(chunk, hi - lo - s0r);
      const int q0 = s0r / p.page, q1 = (s0r + n - 1) / p.page;
      const int j0 = lo / p.page + q0;
      const int slot = (c % (kStages + 1)) * ppc;
      for (int t = tid; t <= q1 - q0; t += kThreads) {
        const int pid = max(trow[j0 + t], 0);
        const int blk = (pid % p.B) * nb + pid / p.B;
        s_blk[slot + t] = blk;
        if constexpr (kQuant) {
          s_ks[slot + t] = p.k_scale[(size_t)blk * G + g];
          s_vs[slot + t] = p.v_scale[(size_t)blk * G + g];
        }
      }
    }
  };

  float m[RB], l[RB], acc[RB][EPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  for (int c = 0; c < kStages && c < n_chunks; ++c) resolve(c);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's stage and slot free
    if (c + kStages - 1 < n_chunks) issue(c + kStages - 1);
    cp_async_commit();

    const C* sk = ring + (c % kStages) * 2 * tile;
    const C* sv = sk + tile;
    const float* rk = s_rk + (c % kStages) * chunk;
    const float* rv = s_rv + (c % kStages) * chunk;
    const int n = min(chunk, hi - lo - c * chunk);
    // kPB positions a group at a time; the trip count is uniform over the
    // CTA, so the shuffles see every lane
    for (int i0 = 0; i0 < n; i0 += ng * kPB) {
      float kf[kPB][EPL], vf[kPB][EPL], s[kPB][RB];
      bool valid[kPB];
#pragma unroll
      for (int u = 0; u < kPB; ++u) {
        const int i = i0 + u * ng + grp;
        valid[u] = i < n;
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
        if (valid[u] && col_in) {
          loadv(sk + i * ds + j * EPL, kf[u]);
          loadv(sv + i * ds + j * EPL, vf[u]);
          if constexpr (kQuant) {
            const float ks = rk[i], vs = rv[i];
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
              kf[u][e] *= ks;
              vf[u][e] *= vs;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          s[u][r] = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s[u][r] += qr[r][e] * kf[u][e];
        }
      }
      // unguarded: a shuffle under a runtime branch costs the warp a
      // reconvergence, and the heads past R only sum zeros
      for (int o = lp >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kPB; ++u)
#pragma unroll
          for (int r = 0; r < RB; ++r)
            s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], o);
      if (valid[0]) {   // positions rise with u: none valid past the first
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (live(r)) {
            float mn = m[r];
#pragma unroll
            for (int u = 0; u < kPB; ++u)
              if (valid[u]) mn = fmaxf(mn, s[u][r]);
            const float alpha = expf(m[r] - mn);   // 0 while m is -inf
            float pu[kPB], psum = 0.f;
#pragma unroll
            for (int u = 0; u < kPB; ++u) {
              pu[u] = valid[u] ? expf(s[u][r] - mn) : 0.f;
              psum += pu[u];
            }
            l[r] = l[r] * alpha + psum;
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
              float a = acc[r][e] * alpha;
#pragma unroll
              for (int u = 0; u < kPB; ++u) a += pu[u] * vf[u][e];
              acc[r][e] = a;
            }
            m[r] = mn;
          }
        }
      }
    }
    resolve(c + kStages);   // its slot held chunk c - 1, done before the sync
  }

  // merge the groups: the ring is free once every thread left the loop
  cp_async_wait<0>();
  __syncthreads();
  const int accw = EPL * lp;
  float* s_acc = reinterpret_cast<float*>(smem);     // (ng, R, accw)
  float* s_m = s_acc + ng * R * accw;                // (ng, R)
  float* s_l = s_m + ng * R;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (live(r)) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        s_acc[(grp * R + r) * accw + j * EPL + e] = acc[r][e];
      if (j == 0) {
        s_m[grp * R + r] = m[r];
        s_l[grp * R + r] = l[r];
      }
    }
  }
  __syncthreads();

  const int pw = D + 2;   // a partial's head: m, l, acc[D]
  float* ws = p.ws + ((size_t)bg * p.n_split + sp) * R * pw;
  for (int o = tid; o < R * D; o += kThreads) {
    const int r = o / D, d = o - r * D;
    float mx = -INFINITY;
    for (int i = 0; i < ng; ++i) mx = fmaxf(mx, s_m[i * R + r]);
    float sum = 0.f, a = 0.f;
    for (int i = 0; i < ng; ++i) {
      const float wgt = expf(s_m[i * R + r] - mx);   // 0 for an idle group
      sum += s_l[i * R + r] * wgt;
      a += s_acc[(i * R + r) * accw + d] * wgt;
    }
    if (n_live == 1) {
      store(out + o, a / fmaxf(sum, 1e-30f));
    } else {
      ws[r * pw + 2 + d] = a;
      if (d == 0) {
        ws[r * pw] = mx;
        ws[r * pw + 1] = sum;
      }
    }
  }
  if (n_live == 1) return;

  // the last live split of (b, g) merges the partials; the barrier orders
  // the CTA's partial before thread 0's fence and ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(p.counters + bg, 1) == n_live - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* part = p.ws + (size_t)bg * p.n_split * R * pw;
  const size_t stride = (size_t)R * pw;
  for (int o = tid; o < R * D; o += kThreads) {
    const int r = o / D, d = o - r * D;
    const float* pr = part + r * pw;
    // kMergeBatch partials' loads in flight at a time, merged online:
    // one L2 round trip a batch, not one a partial
    float mx = -INFINITY, sum = 0.f, a = 0.f;
    for (int i0 = 0; i0 < n_live; i0 += kMergeBatch) {
      float mi[kMergeBatch], li[kMergeBatch], ai[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const float* pi = pr + (size_t)min(i0 + u, n_live - 1) * stride;
        const bool in = i0 + u < n_live;
        mi[u] = in ? __ldcg(pi) : -INFINITY;
        li[u] = in ? __ldcg(pi + 1) : 0.f;
        ai[u] = in ? __ldcg(pi + 2 + d) : 0.f;
      }
      float bm = mx;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) bm = fmaxf(bm, mi[u]);
      const float rescale = expf(mx - bm);   // 0 while mx is -inf
      sum *= rescale;
      a *= rescale;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const float wgt = expf(mi[u] - bm);
        sum += li[u] * wgt;
        a += ai[u] * wgt;
      }
      mx = bm;
    }
    store(out + o, a / fmaxf(sum, 1e-30f));
  }
  if (tid == 0) p.counters[bg] = 0;
}

// The register-array width for a group of R heads of head_dim D: the
// heads a CTA takes (R / head_chunks) themselves up to 4, else kMaxRB.
inline int heads_bucket(int R, int D) {
  const int rh = R / head_chunks(R, D);
  return rh <= 4 ? rh : kMaxRB;
}

inline bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Host side: fill the plan's derived fields (the runs of heads; the
// chunk; vec, 16-byte copies, when a row of D values is whole 16-byte
// units and whole EPL values and both caches are 16-byte aligned) and
// launch `kernel` on grid (B, G n_hc, n_split), n_split = ceil(Tlen /
// split) as the caller sized the workspace.  The dynamic shared memory
// stays under 48 KB, so no cudaFuncSetAttribute is needed.
template <typename K>
int launch(K kernel, Params p, int es, cudaStream_t stream) {
  p.n_hc = head_chunks(p.R, p.D);
  p.rh = p.R / p.n_hc;
  p.chunk = chunk_rows(p.D, es);
  p.vec = (p.D * es) % 16 == 0 && p.D % epl_of(p.D) == 0 &&
          aligned16(p.k) && aligned16(p.v);
  const size_t smem =
      smem_bytes(p.D, p.rh, p.tables ? p.page : 0, es);
  const int want = p.Tlen > 0 ? (p.Tlen + p.split - 1) / p.split : 1;
  if (smem > (size_t)kMaxSmem || p.n_split != want || p.n_split > 65535 ||
      p.G * p.n_hc > 65535)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(p.B, p.G * p.n_hc, p.n_split), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace decode_sweep
