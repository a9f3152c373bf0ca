// Nearest-neighbour search for Hopper (sm_90a) on the tensor cores: for
// each of nq queries (nq, d) the index and squared L2 distance of the
// nearest of nr refs (nr, d), d^2 = (|q|^2 - 2 q.r) + |r|^2 in f32, not
// clamped at 0; ties go to the lowest index.
//
// Replaces: src/repro/kernels/nn_search.py::_nn_kernel (the Pallas
// kernel that nn_search_pallas launches at :89), one of the paper's
// "atypical" kernels: a reduction over refs, where lws meets reuse.  The
// JAX kernel puts q.r on the TPU's matrix unit; here it runs on wgmma.
//
// Bound on the H100: the dots are 2 nq nr d operations on the tensor
// cores (float32 as three TF32 products each at 495 TF/s, bf16 at 989
// TF/s), the epilogue 3 nq nr f32 operations on the CUDA cores (67
// TF/s), the inputs (nq + nr) d elements read once: operations bound it
// at any real size (4,096 x 65,536 x 128: 0.417 ms f32, 0.0695 ms bf16).
//
// Design: two launches.
//  * The prep pass (prep_kernel) reads Q and R once, a group of lanes a
//    row (a power of two up to 32, along K: coalesced), and writes each
//    row's |x|^2 in f32: queries past nq 0, refs past nr up to the end of
//    the last ref tile +inf, so a padded ref never wins.  For float32 it
//    also writes the TF32 big and small halves of Q and R
//    (csrc/tf32_split.cuh, as the 3xTF32 matmul's split) into K-major
//    workspaces of Kp = d rounded up to 4 (16-byte rows).  bf16 rows that
//    TMA takes (d a multiple of 8, pointers on 16 bytes) are read where
//    they lie; other bf16 rows are copied, padded to Kp = d rounded up to
//    8.  A pad pass, not csrc/matmul_tc.cu's copy loader: it costs one
//    more read and write of Q and R, O((nq + nr) d) against the product's
//    O(nq nr d), and it keeps one product kernel, fed by TMA alone.
//  * The product (nn_kernel): grid (query tiles, ref splits).  A CTA of
//    two consumer warpgroups owns BM = 128 MT queries (MT 64-row wgmma
//    tiles a warpgroup) and sweeps the ref tiles of its split, BN = 128 /
//    MT refs each (a thread holds MT BN f32 for a K step's partial and
//    the sum).  Thread 0 keeps a ring of `stages` stages filled by TMA
//    over the flat sequence (ref tile, K step): the query tile's K slice
//    and the ref tile's, both K-major as they arrive (no transpose), SW =
//    128 or 32 bytes of K a row under the swizzle of that width; rows and
//    K past the tensors are zero-filled.  Per K step each warpgroup
//    issues, for each 32-byte slice of K (k8 for TF32, k16 for bf16), its
//    wgmma products into a fresh partial (f32: small q x big r, big q x
//    small r, big x big, as the 3xTF32 matmul; bf16: one product, exact
//    in f32), waits for them and adds the partial to an f32 sum on the
//    CUDA cores, rounding to nearest: the tensor cores' truncating
//    accumulation never runs past one K step (the first step writes the
//    sum itself).
//  * The epilogue replaces the store: after a ref tile's last K step each
//    thread forms d^2 = (|q|^2 - 2 s) + |r|^2 for the accumulator
//    elements it holds (fmaf(-2, s, |q|^2) is |q|^2 - 2 s rounded once,
//    since 2 s is exact) and keeps, per query row, a running (min,
//    argmin), visiting its columns in ascending ref order with a strict
//    "<".  No part of the nq x nr distances reaches memory.  At the end
//    of the split the 4 lanes of a quad, which hold one row's columns
//    between them, reduce by the lexicographic (d^2, index) order.
//  * The merge: with one split the CTA writes the result; else it writes
//    its per-row partial and takes a ticket on its query tile (atomicAdd
//    after a fence, as csrc/decode_sweep.cuh), and the last CTA of the
//    tile merges the splits' partials in ascending split order with a
//    strict "<", then resets the ticket.  The result does not depend on
//    the order the CTAs finish in, and ties go to the lowest index across
//    splits too.
// The TMA descriptors are encoded on the host for each call; the TMA,
// mbarrier and descriptor helpers are csrc/tma_wgmma.cuh's.
//
// Takes: Q (nq, d) and R (nr, d) row-major, float32 or bfloat16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "smem_optin.cuh"
#include "tf32_split.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace tma_wgmma;

constexpr int kThreads = 256;      // the product: two consumer warpgroups
constexpr int kWG = 128;           // threads of a warpgroup
constexpr int kMaxStages = 4;
constexpr int kPrepThreads = 256;
constexpr int kMergeBatch = 8;     // partials' loads in flight a row

enum PrepMode { kNorms = 0, kCopy = 1, kSplit = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------------------ prep

// Rows 0 ... nq_pad - 1 are queries, nq_pad ... nq_pad + nr_pad - 1 refs;
// a group of 2^g_log2 lanes takes a row, its lanes k, k + G, ... of Kp.
// ws: kSplit: Q big, Q small (nq, kp) then R big, R small (nr, kp), f32;
// kCopy: Q (nq, kp) then R (nr, kp) in T; kNorms: unused.
template <typename T, int MODE>
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const T* __restrict__ q, const T* __restrict__ r,
            void* __restrict__ ws, float* __restrict__ norms, int nq, int nr,
            int d, int kp, int nq_pad, int nr_pad, int g_log2) {
  const int lane = threadIdx.x % 32;
  const int G = 1 << g_log2;
  const int sub = lane & (G - 1);
  const long long rows = (long long)nq_pad + nr_pad;
  const long long per_warp = 32 >> g_log2;
  const long long warp =
      ((long long)blockIdx.x * kPrepThreads + threadIdx.x) / 32;
  const long long step = (long long)gridDim.x * (kPrepThreads / 32) * per_warp;
  // every lane runs every trip (the shuffles below take the whole warp)
  for (long long row = warp * per_warp + lane / G; row - lane / G < rows;
       row += step) {
    const bool is_q = row < nq_pad;
    const long long lr = is_q ? row : row - nq_pad;
    const int n = is_q ? nq : nr;
    const bool real = row < rows && lr < n;
    const T* src = (is_q ? q : r) + (real ? lr * d : 0);
    float acc = 0.f;
    for (int k = sub; k < kp; k += G) {
      const float x = real && k < d ? to_f32(src[k]) : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(x, x));
      if constexpr (MODE == kSplit) {
        float* w = static_cast<float*>(ws) + (is_q ? 0 : 2 * (size_t)nq * kp);
        const size_t half = (size_t)n * kp, o = (size_t)lr * kp + k;
        if (real) tf32_split::split_store(x, w + o, w + half + o);
      } else if constexpr (MODE == kCopy) {
        __nv_bfloat16* w = static_cast<__nv_bfloat16*>(ws) +
                           (is_q ? 0 : (size_t)nq * kp);
        if (real) w[(size_t)lr * kp + k] = __float2bfloat16(x);
      }
    }
    for (int o = G / 2; o > 0; o /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (sub == 0 && row < rows)
      norms[row] = real ? acc : (is_q ? 0.f : CUDART_INF_F);
  }
}

// --------------------------------------------------------------- product

// D(64 x N, f32) = A(64 x K, K-major) B(N x K, K-major) (+ D unless
// scale_d is 0): K = 8 TF32 for float, 16 bf16 for __nv_bfloat16
template <typename T, int N>
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db,
                                    int scale_d);

template <>
__device__ __forceinline__ void mma<float, 64>(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma<float, 128>(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma<__nv_bfloat16, 64>(float* d,
                                                       uint64_t da,
                                                       uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma<__nv_bfloat16, 128>(float* d,
                                                        uint64_t da,
                                                        uint64_t db,
                                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <typename T, int MT, int SW>
struct Tile {
  static constexpr int BM = 128 * MT;          // queries a CTA
  static constexpr int BN = 128 / MT;          // refs a ref tile
  static constexpr int NA = BN / 2;            // f32 of one 64-row tile
  static constexpr int H = sizeof(T) == 4 ? 2 : 1;   // big and small
  static constexpr int ABytes = BM * SW;       // one half, one K step
  static constexpr int BBytes = BN * SW;
  static constexpr int Stage = H * (ABytes + BBytes);
  static constexpr int BK = SW / (int)sizeof(T);     // K a step
  static constexpr int Slices = SW / 32;       // 32-byte wgmma K slices
};

// wgmma descriptor of a K-major tile under the SW-byte swizzle: 8-row
// groups 8 SW bytes apart
template <int SW>
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) {
  return desc(addr, 16, 8 * SW, SW == 128 ? 1 : 3);
}

// One K step's products into acc, which the step's first product
// overwrites (scale-d 0): a0 is the warpgroup's query rows, b0 the ref
// tile, in one stage (each operand's big half first, then its small one)
template <typename T, int MT, int SW>
__device__ __forceinline__ void issue(float (&acc)[MT][Tile<T, MT, SW>::NA],
                                      uint32_t a0, uint32_t b0) {
  using L = Tile<T, MT, SW>;
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs<L::NA>(acc[m]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::Slices; ++kk) {
    const uint32_t o = kk * 32;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint32_t am = a0 + m * 64 * SW + o;
      if constexpr (L::H == 2) {   // small q big r, big q small r, big big
        mma<T, L::BN>(acc[m], kdesc<SW>(am + L::ABytes), kdesc<SW>(b0 + o),
                      kk > 0);
        mma<T, L::BN>(acc[m], kdesc<SW>(am), kdesc<SW>(b0 + L::BBytes + o),
                      1);
        mma<T, L::BN>(acc[m], kdesc<SW>(am), kdesc<SW>(b0 + o), 1);
      } else {
        mma<T, L::BN>(acc[m], kdesc<SW>(am), kdesc<SW>(b0 + o), kk > 0);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs<L::NA>(acc[m]);
}

struct Params {
  const float* norms;    // |q|^2 (nq_pad) then |r|^2 (ref_tiles BN)
  int* idx;
  float* dist;
  float* part_d;         // (splits, nq_pad): each split's per-row minimum
  int* part_i;
  int* tickets;          // (query tiles,), 0 between launches
  int nq, nq_pad, ref_tiles, kt, split_tiles, stages;
};

template <typename T, int MT, int SW>
__global__ void __launch_bounds__(kThreads, 1)
nn_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tqs,
          const __grid_constant__ CUtensorMap tr,
          const __grid_constant__ CUtensorMap trs, const Params p) {
  using L = Tile<T, MT, SW>;
  constexpr int NA = L::NA;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles sit on 1024-byte boundaries; every tile is a multiple
  // of the swizzle atom (1024 or 256 bytes)
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * L::Stage);
  uint64_t* empty = full + kMaxStages;
  // the merge's flag in dynamic shared memory: a static __shared__ would
  // cut the dynamic limit below the opt-in maximum that smem_optin sets
  int& s_last = *reinterpret_cast<int*>(empty + kMaxStages);
  const int tid = threadIdx.x;
  const int wg = tid / kWG, warp = (tid % kWG) / 32, lane = tid % 32;
  const int q4 = lane % 4;
  const int qtile = blockIdx.x, sp = blockIdx.y;
  const int row0 = qtile * L::BM;
  const int t0 = sp * p.split_tiles;
  const int iters = min(p.split_tiles, p.ref_tiles - t0) * p.kt;

  // step i (ref tile t0 + i / kt, K step i % kt) into stage s: the query
  // tile's halves, then the ref tile's
  auto load = [&](int i, int s) {
    const int t = i / p.kt;
    const int kc = (i - t * p.kt) * L::BK, rr = (t0 + t) * L::BN;
    uint8_t* st = smem + s * L::Stage;
    mbar_expect_tx(&full[s], L::Stage);
    tma_load(st, &tq, kc, row0, &full[s]);
    if constexpr (L::H == 2)
      tma_load(st + L::ABytes, &tqs, kc, row0, &full[s]);
    tma_load(st + L::H * L::ABytes, &tr, kc, rr, &full[s]);
    if constexpr (L::H == 2)
      tma_load(st + 2 * L::ABytes + L::BBytes, &trs, kc, rr, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);           // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < p.stages && i < iters; ++i) load(i, i);

  // accumulator fragment of 64-row tile m: register 4 j + 2 h + e holds
  // query row (wg MT + m) 64 + 16 warp + lane / 4 + 8 h, ref column
  // 8 j + 2 q4 + e of the ref tile
  float part[MT][NA], sum[MT][NA], qn[MT][2], best[MT][2];
  int arg[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row =
          row0 + (wg * MT + m) * 64 + warp * 16 + lane / 4 + 8 * h;
      qn[m][h] = __ldg(p.norms + row);
      best[m][h] = CUDART_INF_F;
      arg[m][h] = 0;
    }

  int k = 0, t = 0;
  for (int i = 0; i < iters; ++i) {
    const int s = i % p.stages;
    const bool last = k == p.kt - 1;
    // the ref tile's |r|^2 at this thread's columns, loaded while the
    // products run
    float2 rn[L::BN / 8];
    if (last) {
      const float* rp = p.norms + p.nq_pad + (t0 + t) * L::BN + 2 * q4;
#pragma unroll
      for (int j = 0; j < L::BN / 8; ++j)
        rn[j] = __ldg(reinterpret_cast<const float2*>(rp + 8 * j));
    }
    mbar_wait(&full[s], (i / p.stages) & 1);
    const uint32_t a0 = smem_u32(smem + s * L::Stage) + wg * MT * 64 * SW;
    const uint32_t b0 = smem_u32(smem + s * L::Stage + L::H * L::ABytes);
    if (k == 0) {
      issue<T, MT, SW>(sum, a0, b0);
    } else {
      issue<T, MT, SW>(part, a0, b0);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NA; ++j) sum[m][j] += part[m][j];
    }
    if (tid % kWG == 0) mbar_arrive(&empty[s]);   // stage s is free
    if (tid == 0 && i + p.stages < iters) {
      mbar_wait(&empty[s], (i / p.stages) & 1);
      load(i + p.stages, s);
    }
    __syncwarp();
    if (!last) {
      ++k;
      continue;
    }
    const int col0 = (t0 + t) * L::BN + 2 * q4;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < L::BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d2 =
                __fadd_rn(fmaf(-2.f, sum[m][4 * j + 2 * h + e], qn[m][h]),
                          e ? rn[j].y : rn[j].x);
            if (d2 < best[m][h]) {
              best[m][h] = d2;
              arg[m][h] = col0 + 8 * j + e;
            }
          }
    k = 0;
    ++t;
  }

  // the quad's 4 lanes hold one row's columns: lexicographic minimum
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o *= 2) {
        const float od = __shfl_xor_sync(0xffffffffu, best[m][h], o);
        const int oi = __shfl_xor_sync(0xffffffffu, arg[m][h], o);
        if (od < best[m][h] || (od == best[m][h] && oi < arg[m][h])) {
          best[m][h] = od;
          arg[m][h] = oi;
        }
      }
  const bool one = gridDim.y == 1;
  if (q4 == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row =
            row0 + (wg * MT + m) * 64 + warp * 16 + lane / 4 + 8 * h;
        if (one) {
          if (row < p.nq) {
            p.idx[row] = arg[m][h];
            p.dist[row] = best[m][h];
          }
        } else {
          const size_t o = (size_t)sp * p.nq_pad + row;
          p.part_d[o] = best[m][h];
          p.part_i[o] = arg[m][h];
        }
      }
  }
  if (one) return;

  // the last split of the query tile merges the partials; the barrier
  // orders the CTA's partials before thread 0's fence and ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(p.tickets + qtile, 1) == (int)gridDim.y - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int splits = gridDim.y;
  for (int rr = tid; rr < L::BM; rr += kThreads) {
    const int row = row0 + rr;
    if (row >= p.nq) break;
    float bd = CUDART_INF_F;
    int bi = 0;
    for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
      float dv[kMergeBatch];
      int iv[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const bool in = s0 + u < splits;
        const size_t o = (size_t)(in ? s0 + u : 0) * p.nq_pad + row;
        dv[u] = in ? __ldcg(p.part_d + o) : CUDART_INF_F;
        iv[u] = in ? __ldcg(p.part_i + o) : 0;
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)   // ascending splits, strict <
        if (dv[u] < bd) {
          bd = dv[u];
          bi = iv[u];
        }
    }
    p.idx[row] = bi;
    p.dist[row] = bd;
  }
  if (tid == 0) p.tickets[qtile] = 0;
}

// a K-major matrix (rows, kp) of T read in (box_k, box_rows) boxes under
// the SW-byte swizzle; rows and K past the matrix read as zeros
template <typename T, int SW>
bool encode(CUtensorMap* map, const void* ptr, int rows, int kp,
            int box_rows) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(SW / sizeof(T)),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map,
            sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int MT, int SW>
size_t smem_bytes(int stages) {
  return (size_t)stages * Tile<T, MT, SW>::Stage + 2 * kMaxStages * 8 + 16 +
         1024;
}

template <typename T, int MT, int SW>
cudaError_t allow_smem() {
  static std::atomic<unsigned> devices{0};
  return smem_optin::allow((const void*)nn_kernel<T, MT, SW>, devices);
}

// q and r: the K-major sources (kp columns): for float32 the split's big
// halves, each followed by its small half; for bf16 the inputs or their
// padded copies
template <typename T, int MT, int SW>
int launch(const void* q, const void* r, Params p, int nr, int kp,
           int splits, cudaStream_t stream) {
  using L = Tile<T, MT, SW>;
  cudaError_t err = allow_smem<T, MT, SW>();
  if (err != cudaSuccess) return (int)err;
  const size_t qh = (size_t)p.nq * kp * sizeof(T);   // bytes of a half
  const size_t rh = (size_t)nr * kp * sizeof(T);
  const char* qc = static_cast<const char*>(q);
  const char* rc = static_cast<const char*>(r);
  CUtensorMap tq, tqs, tr, trs;
  if (!encode<T, SW>(&tq, qc, p.nq, kp, L::BM) ||
      !encode<T, SW>(&tqs, L::H == 2 ? qc + qh : qc, p.nq, kp, L::BM) ||
      !encode<T, SW>(&tr, rc, nr, kp, L::BN) ||
      !encode<T, SW>(&trs, L::H == 2 ? rc + rh : rc, nr, kp, L::BN))
    return (int)cudaErrorInvalidValue;
  p.kt = (kp + L::BK - 1) / L::BK;
  const dim3 grid(p.nq_pad / L::BM, splits);
  nn_kernel<T, MT, SW><<<grid, kThreads, smem_bytes<T, MT, SW>(p.stages),
                         stream>>>(tq, tqs, tr, trs, p);
  return (int)cudaGetLastError();
}

template <typename T, int MT, int SW>
int occupancy(int stages, int* blocks) {
  cudaError_t err = allow_smem<T, MT, SW>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, nn_kernel<T, MT, SW>, kThreads, smem_bytes<T, MT, SW>(stages));
}

// one call per (T, MT, SW) instantiation: F is launch or occupancy
#define NN_DISPATCH_SW(T, MT, F, ...)                         \
  if (sw == 128) return F<T, MT, 128>(__VA_ARGS__);           \
  if (sw == 32) return F<T, MT, 32>(__VA_ARGS__);             \
  return (int)cudaErrorInvalidValue;

#define NN_DISPATCH_MT(T, F, ...)                             \
  if (mt == 1) { NN_DISPATCH_SW(T, 1, F, __VA_ARGS__) }       \
  if (mt == 2) { NN_DISPATCH_SW(T, 2, F, __VA_ARGS__) }       \
  return (int)cudaErrorInvalidValue;

#define NN_DISPATCH(F, ...)                                   \
  if (dtype == 0) { NN_DISPATCH_MT(float, F, __VA_ARGS__) }   \
  if (dtype == 1) { NN_DISPATCH_MT(__nv_bfloat16, F, __VA_ARGS__) } \
  return (int)cudaErrorInvalidValue;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int MODE>
int prep(const void* q, const void* r, void* ws, float* norms, int nq,
         int nr, int d, int kp, int nq_pad, int nr_pad, cudaStream_t st) {
  int g_log2 = 0;
  while (g_log2 < 5 && (1 << g_log2) < kp) ++g_log2;
  const long long rows = (long long)nq_pad + nr_pad;
  const long long per_cta = (kPrepThreads / 32) * (32 >> g_log2);
  const long long grid = (rows + per_cta - 1) / per_cta;
  prep_kernel<T, MODE><<<(unsigned)(grid < 65536 ? grid : 65536),
                         kPrepThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(r), ws, norms, nq, nr,
      d, kp, nq_pad, nr_pad, g_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// The prep pass.  q (nq, d), r (nr, d) row-major; norms (nq_pad +
// nr_pad) f32; mode 0: the norms alone (bf16 that TMA takes), 1: the
// norms and a bf16 copy into ws, Q (nq, kp) then R (nr, kp), K padded
// with zeros; 2 (float32): the norms and the TF32 split into ws, Q big,
// Q small (nq, kp), then R big, R small (nr, kp).  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int nn_prep(const void* q, const void* r, void* ws, void* norms,
                       int nq, int nr, int d, int kp, int nq_pad,
                       int nr_pad, int mode, int dtype, void* stream) {
  if (nq < 1 || nr < 1 || d < 1 || kp < d || nq_pad < nq || nr_pad < nr ||
      (mode != kNorms && ws == nullptr) ||
      (dtype == 0) != (mode == kSplit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* nm = static_cast<float*>(norms);
  if (mode == kSplit)
    return prep<float, kSplit>(q, r, ws, nm, nq, nr, d, kp, nq_pad, nr_pad,
                               st);
  if (mode == kCopy)
    return prep<__nv_bfloat16, kCopy>(q, r, ws, nm, nq, nr, d, kp, nq_pad,
                                      nr_pad, st);
  if (mode == kNorms)
    return prep<__nv_bfloat16, kNorms>(q, r, ws, nm, nq, nr, d, kp, nq_pad,
                                       nr_pad, st);
  return (int)cudaErrorInvalidValue;
}

// The product.  q, r: the K-major sources of kp columns (nn_prep's
// workspaces, or bf16 inputs that TMA takes: kp = d, a multiple of 8);
// norms as nn_prep wrote them, nq_pad = the query tiles x 128 mt and the
// refs' part ref_tiles x 128 / mt; idx (nq,) int32 and dist (nq,) f32 out;
// part_d, part_i (splits, nq_pad) and tickets (query tiles, zero) for a
// grid of several splits.  mt in {1, 2}; sw in {32, 128}; stages in
// [2, 4]; split_tiles ref tiles a split.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int nn_product(const void* q, const void* r, const void* norms,
                          void* idx, void* dist, void* part_d, void* part_i,
                          void* tickets, int nq, int nr, int kp, int nq_pad,
                          int mt, int sw, int split_tiles, int splits,
                          int stages, int dtype, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  const int bm = 128 * mt, bn = mt > 0 ? 128 / mt : 1;
  const int ref_tiles = (nr + bn - 1) / bn;
  if (nq < 1 || nr < 1 || kp < 1 || (kp * es) % 16 != 0 ||
      (mt != 1 && mt != 2) || (sw != 32 && sw != 128) || stages < 2 ||
      stages > kMaxStages || split_tiles < 1 || splits < 1 ||
      splits > 65535 || (long long)(splits - 1) * split_tiles >= ref_tiles ||
      (long long)splits * split_tiles < ref_tiles || nq_pad % bm != 0 ||
      nq_pad < nq || !aligned16(q) || !aligned16(r) ||
      (splits > 1 && (part_d == nullptr || part_i == nullptr ||
                      tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(norms), static_cast<int*>(idx),
           static_cast<float*>(dist), static_cast<float*>(part_d),
           static_cast<int*>(part_i), static_cast<int*>(tickets), nq,
           nq_pad, ref_tiles, 0, split_tiles, stages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  NN_DISPATCH(launch, q, r, p, nr, kp, splits, st)
}

// Resident CTAs per SM that the CUDA runtime reports for one
// instantiation of the product at its shared memory.
extern "C" int nn_occupancy(int mt, int sw, int stages, int dtype,
                            int* blocks) {
  if (stages < 2 || stages > kMaxStages) return (int)cudaErrorInvalidValue;
  NN_DISPATCH(occupancy, stages, blocks)
}
