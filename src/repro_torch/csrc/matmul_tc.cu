// bf16 matmul on Hopper's tensor cores: TMA or the CTA's own copies into
// a ring of shared-memory stages, wgmma products, f32 accumulators in
// registers (sm_90a).
//
// Replaces: src/repro/kernels/matmul.py::_matmul_kernel (the Pallas
// kernel that matmul_pallas launches at :66) for bfloat16 operands.  The
// Pallas kernel casts both operands to f32 and accumulates in f32; a
// product of two bf16 values is exact in f32, so
// wgmma.mma_async.f32.bf16.bf16 computes the same function and only the
// order of the sums differs.  Every contiguous bf16 pair runs here, of
// any shape and alignment; float32 operands run as 3xTF32
// (csrc/matmul_tf32x3.cu).
//
// Bound on the H100: 2 M N K operations against (M K + K N) bf16 read and
// M N written; at 4096^3 that is ~1,400 FLOP a byte, far above the
// card's ~295, so the bf16 tensor-core rate (989 TF/s) bounds it.  At a
// decode row (M = 8) the bytes of B bound it.
//
// Design.  A CTA owns a BM x BN output tile, BM = 64 WGS for WGS = 1 or 2
// consumer warpgroups, BN in {8, ..., 256}.  K is swept in steps of 64
// (128 bytes of bf16, one 128-byte swizzle row of A).  A stage holds A's
// tile (64 K x BM rows, K-major, 128B swizzle) and B's boxes (64 K rows x
// up to 64 N columns, MN-major, the swizzle that matches the box's row of
// 16 to 128 bytes); `stages` (2 to 4) of them form a ring, each with a
// `full` and an `empty` mbarrier.  Each warpgroup issues four
// wgmma.m64nBNk16 per K step on its 64 rows (B transposed in the
// instruction: it is MN-major), commits, and waits for the step before,
// so one step's products are in flight while the next stage's barrier is
// awaited; a stage is refilled once every consumer warpgroup has
// arrived on its `empty` mbarrier.  The epilogue converts the f32
// accumulators and stores them with the edges masked.
//
// Each operand has its loader, a template parameter:
//  * kTma: a row stride and a pointer on 16 bytes.  Thread 0 keeps the
//    ring filled by TMA `stages - 1` tiles ahead, between its own
//    products; completion is counted in bytes on the stage's `full`
//    mbarrier, and TMA fills loads past the edges with zeros.  There is
//    no producer warp, so the CTA is 128 or 256 threads and every thread
//    keeps its registers (BN / 2 accumulators; no setmaxnreg).  The TMA
//    descriptors are encoded on the host for each call
//    (cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint so
//    no -lcuda is needed) and passed as __grid_constant__ parameters.
//  * kCopy: everything else (K or N not a multiple of 8, a pointer off
//    16 bytes), which TMA cannot describe.  Every thread of the CTA
//    copies its share of the tile at the refill point in the K loop,
//    each element to the byte that the TMA box would have written under
//    the tile's swizzle, with the widest access the operand's row
//    stride and pointer allow: 8 or 4 bytes by cp.async (source size 0
//    past M, N or K: zeros, as TMA's fill), or 2 bytes through
//    registers when a row starts on an odd element.  A thread's cp.async
//    copies arrive on `full` when they land
//    (cp.async.mbarrier.arrive.noinc), its register copies after a
//    proxy fence; `full` counts those arrivals and, when the other
//    operand is TMA's, thread 0's transaction bytes.  The consumers
//    fence the async proxy after the wait, since wgmma reads what the
//    generic proxy wrote.  The TMA-TMA instantiation is the kernel
//    without the copy loader: every copy path is `if constexpr`.
// The TMA, mbarrier and wgmma helpers are csrc/tma_wgmma.cuh's, shared
// with csrc/matmul_tf32x3.cu.
//
// Takes: A (M, K) and B (K, N) row-major bf16 on 2-byte boundaries; C
// (M, N) f32 or bf16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "smem_optin.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace tma_wgmma;

constexpr int kBK = 64;            // K step: 128 bytes of bf16
constexpr int kMaxStages = 4;
constexpr int kWG = 128;           // threads of a warpgroup

// B's TMA box: up to 64 columns (128 bytes) a row, BN / kBox boxes a stage
template <int BN>
struct BTile {
  static constexpr int kBox = BN < 64 ? BN : 64;
  static constexpr int kPitch = 2 * kBox;          // bytes of one K row
  static constexpr int kBoxes = BN / kBox;
  static constexpr int kBoxBytes = kBK * kPitch;
  // wgmma layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle, 0 = none
  static constexpr uint64_t kLayout =
      kPitch == 128 ? 1 : kPitch == 64 ? 2 : kPitch == 32 ? 3 : 0;
  // stride between 8-row K groups; between 64-column boxes (MN repeat)
  static constexpr uint32_t kKGroup = 8 * kPitch;
  static constexpr uint32_t kMNStride = kBoxes > 1 ? kBoxBytes : kKGroup;
};

// D(64 x N, f32) += A(64 x 16, K-major) B(16 x N, MN-major)
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<16>(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<256>(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
      "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


enum Loader { kTma, kCopy };

// Byte `o` of a tile whose rows are `pitch` bytes, where TMA writes it
// under the swizzle of that pitch (128B, 64B, 32B; none at 16): the
// 16-byte chunk index (bits 4..6) XORed with the 128-byte line (bits
// 7..9), as many bits of it as the swizzle spans.  The tiles sit on
// 1024-byte boundaries, so the offset's bits are the address's.
template <int PITCH>
__device__ __forceinline__ uint32_t swizzled(uint32_t o) {
  constexpr uint32_t kMask = PITCH == 128 ? 7 : PITCH == 64 ? 3
                             : PITCH == 32 ? 1 : 0;
  return o ^ (((o >> 7) & kMask) << 4);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival on `bar` once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// VB (4 or 8) bytes from global to shared; zeros when !in (source size 0)
template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(VB), "r"(in ? VB : 0)
               : "memory");
}

// One thread's share of the copy loader: the ROWS x COLS tile at (r0, c0)
// of a row-major bf16 operand (row stride ld, rows < rmax, columns <
// cmax; zeros past them) into the stage `st`, element (r, c) at byte
// place(r, c), VB bytes a copy (consecutive threads, consecutive copies
// along a row).  VB 2 goes through registers, eight copies in flight.
template <int VB, int ROWS, int COLS, int THREADS, typename Place>
__device__ __forceinline__ void copy_share(const __nv_bfloat16* g, int ld,
                                           int r0, int c0, int rmax,
                                           int cmax, uint8_t* st,
                                           Place place, int tid) {
  constexpr int kVE = VB / 2, kPerRow = COLS / kVE;
  constexpr int kTotal = ROWS * kPerRow;
  constexpr int kCopies = (kTotal + THREADS - 1) / THREADS;  // per thread
  if constexpr (VB > 2) {
#pragma unroll 8
    for (int j = 0; j < kCopies; ++j) {
      const int i = tid + j * THREADS;
      // fewer copies than threads only at BN 8 on two warpgroups
      if (kTotal % THREADS != 0 && i >= kTotal) break;
      const int r = i / kPerRow, c = i % kPerRow * kVE;
      const bool in = r0 + r < rmax && c0 + c < cmax;
      cp_async<VB>(st + place(r, c),
                   in ? g + (size_t)(r0 + r) * ld + c0 + c : g, in);
    }
  } else {
    constexpr int kBatch = kCopies < 8 ? kCopies : 8;
    static_assert(kTotal % (THREADS * kBatch) == 0, "uneven copy batches");
    const uint16_t* g16 = reinterpret_cast<const uint16_t*>(g);
#pragma unroll 1
    for (int j0 = 0; j0 < kCopies; j0 += kBatch) {
      uint16_t v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (j0 + u) * THREADS;
        const int r = i / kPerRow, c = i % kPerRow;
        v[u] = r0 + r < rmax && c0 + c < cmax
                   ? __ldg(g16 + (size_t)(r0 + r) * ld + c0 + c)
                   : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (j0 + u) * THREADS;
        *reinterpret_cast<uint16_t*>(st + place(i / kPerRow, i % kPerRow)) =
            v[u];
      }
    }
  }
}

template <int ROWS, int COLS, int THREADS, typename Place>
__device__ __forceinline__ void copy_tile(int vb, const __nv_bfloat16* g,
                                          int ld, int r0, int c0, int rmax,
                                          int cmax, uint8_t* st, Place place,
                                          int tid) {
  if (vb == 8)
    copy_share<8, ROWS, COLS, THREADS>(g, ld, r0, c0, rmax, cmax, st, place,
                                       tid);
  else if (vb == 4)
    copy_share<4, ROWS, COLS, THREADS>(g, ld, r0, c0, rmax, cmax, st, place,
                                       tid);
  else
    copy_share<2, ROWS, COLS, THREADS>(g, ld, r0, c0, rmax, cmax, st, place,
                                       tid);
}

// What the copy loader reads: the operands and each one's copy width in
// bytes (8, 4 or 2; 16 means TMA's)
struct CopySrc {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  int wa, wb;
};

template <int BN, int WGS, Loader LA, Loader LB>
__global__ void __launch_bounds__(kWG * WGS, 1)
matmul_tc_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b,
                 const CopySrc src, void* __restrict__ C, int M, int N,
                 int K, int stages, int out_bf16) {
  using BT = BTile<BN>;
  constexpr int BM = 64 * WGS;
  constexpr int kThreads = kWG * WGS;
  constexpr int kABytes = BM * kBK * 2, kBBytes = kBK * BN * 2;
  constexpr int kStage = kABytes + kBBytes;
  constexpr bool kCopyA = LA == kCopy, kCopyB = LB == kCopy;
  constexpr bool kAnyCopy = kCopyA || kCopyB;
  constexpr int kTmaBytes = (kCopyA ? 0 : kABytes) + (kCopyB ? 0 : kBBytes);
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles sit on 1024-byte boundaries (the swizzle atom)
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStage);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = (K + kBK - 1) / kBK;
  // a copying thread arrives on `full` once for its cp.async copies and
  // once for its register copies, each where it has any
  const bool async_arrive = (kCopyA && src.wa > 2) || (kCopyB && src.wb > 2);
  const bool reg_arrive = (kCopyA && src.wa == 2) || (kCopyB && src.wb == 2);

  auto load = [&](int t, int s) {         // K tile t into stage s
    uint8_t* st = smem + s * kStage;
    if constexpr (kTmaBytes > 0) {
      if (!kAnyCopy || tid == 0) {         // TMA alone: only thread 0 loads
        mbar_expect_tx(&full[s], kTmaBytes);
        if constexpr (!kCopyA) tma_load(st, &tma_a, t * kBK, row0, &full[s]);
        if constexpr (!kCopyB) {
#pragma unroll
          for (int j = 0; j < BT::kBoxes; ++j)
            tma_load(st + kABytes + j * BT::kBoxBytes, &tma_b,
                     col0 + j * BT::kBox, t * kBK, &full[s]);
        }
      }
    }
    if constexpr (kCopyA)
      copy_tile<BM, kBK, kThreads>(
          src.wa, src.a, K, row0, t * kBK, M, K, st,
          [](int r, int c) { return swizzled<128>(r * 128 + c * 2); }, tid);
    if constexpr (kCopyB)
      copy_tile<kBK, BN, kThreads>(
          src.wb, src.b, N, t * kBK, col0, K, N, st + kABytes,
          [](int r, int c) {
            return c / BT::kBox * BT::kBoxBytes +
                   swizzled<BT::kPitch>(r * BT::kPitch + c % BT::kBox * 2);
          },
          tid);
    if constexpr (kAnyCopy) {
      if (async_arrive) cp_async_arrive(&full[s]);
      if (reg_arrive) {
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
  };

  if (tid == 0) {
    const int arrivals = kAnyCopy ? kThreads * (async_arrive + reg_arrive) +
                                        (kTmaBytes > 0)
                                  : 1;
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], arrivals);
      mbar_init(&empty[s], WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kAnyCopy || tid == 0)
    for (int t = 0; t < stages && t < KT; ++t) load(t, t);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int k = 0; k < KT; ++k) {
    const int s = k % stages;
    mbar_wait(&full[s], (k / stages) & 1);
    if constexpr (kAnyCopy) fence_proxy_async();
    const uint32_t a0 = smem_u32(smem + s * kStage) + wg * 64 * 128;
    const uint32_t b0 = smem_u32(smem + s * kStage + kABytes);
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma<BN>(acc, desc(a0 + kk * 32, 16, 1024, 1),
                desc(b0 + kk * 16 * BT::kPitch, BT::kMNStride, BT::kKGroup,
                     BT::kLayout));
    wgmma_commit();
    wgmma_wait<1>();                       // step k - 1 has finished
    fence_regs<BN / 2>(acc);
    if (k > 0) {
      const int ps = (k - 1) % stages;
      if (tid % kWG == 0) mbar_arrive(&empty[ps]);
      if ((kAnyCopy || tid == 0) && k - 1 + stages < KT) {
        mbar_wait(&empty[ps], ((k - 1) / stages) & 1);
        load(k - 1 + stages, ps);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);

  // accumulator fragment: register 4 j + 2 h + e holds row
  // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const int lane = tid % 32, warp = (tid % kWG) / 32;
  const int r_lo = row0 + wg * 64 + warp * 16 + lane / 4;
  // an odd N (copied B only) puts every other row's pairs off their
  // alignment: store single elements
  const bool pairs = !kCopyB || N % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;                // pairs: col + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + 8 * h;
      if (row >= M) continue;
      const size_t o = (size_t)row * N + col;
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (pairs) {
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(C) + o) =
              __floats2bfloat162_rn(x, y);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(C) + o) =
              make_float2(x, y);
      } else if (out_bf16) {
        __nv_bfloat16* c = static_cast<__nv_bfloat16*>(C) + o;
        c[0] = __float2bfloat16_rn(x);
        if (col + 1 < N) c[1] = __float2bfloat16_rn(y);
      } else {
        float* c = static_cast<float*>(C) + o;
        c[0] = x;
        if (col + 1 < N) c[1] = y;
      }
    }
  }
}

// a 2-D row-major bf16 tensor (rows, cols) read in (box_rows, box_cols) boxes
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols,
            int box_rows, int box_cols, int pitch_bytes) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swz =
      pitch_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : pitch_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : pitch_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                          : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t smem_bytes(int bm, int bn, int stages) {
  return (size_t)stages * (bm + bn) * kBK * 2 + 2 * kMaxStages * 8 + 1024;
}

// The widest access a row-major bf16 operand of `cols` columns allows, in
// bytes: 16 (TMA's: the pointer and the row stride on 16 bytes), 8, 4 or 2
int copy_width(const void* p, int cols) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(p) | (uintptr_t)cols * 2;
  return x % 16 == 0 ? 16 : x % 8 == 0 ? 8 : x % 4 == 0 ? 4 : 2;
}

template <int BN, int WGS, Loader LA, Loader LB>
cudaError_t allow_smem() {
  static std::atomic<unsigned> devices{0};
  return smem_optin::allow((const void*)matmul_tc_kernel<BN, WGS, LA, LB>,
                           devices);
}

template <int BN, int WGS, Loader LA, Loader LB>
int launch_as(const CopySrc& src, void* c, int M, int N, int K, int stages,
              int out_bf16, cudaStream_t stream) {
  using BT = BTile<BN>;
  constexpr int BM = 64 * WGS;
  cudaError_t err = allow_smem<BN, WGS, LA, LB>();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ta{}, tb{};
  if ((LA == kTma && !encode(&ta, src.a, M, K, BM, kBK, 128)) ||
      (LB == kTma && !encode(&tb, src.b, K, N, kBK, BT::kBox, BT::kPitch)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_tc_kernel<BN, WGS, LA, LB><<<grid, kWG * WGS,
                                      smem_bytes(BM, BN, stages), stream>>>(
      ta, tb, src, c, M, N, K, stages, out_bf16);
  return (int)cudaGetLastError();
}

template <int BN, int WGS, Loader LA, Loader LB>
int occupancy_as(int stages, int* blocks) {
  cudaError_t err = allow_smem<BN, WGS, LA, LB>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, matmul_tc_kernel<BN, WGS, LA, LB>, kWG * WGS,
      smem_bytes(64 * WGS, BN, stages));
}

// one call of F<BN, WGS, LA, LB> for the operands' loaders (a width of 16
// is TMA's)
#define TC_DISPATCH_LOADERS(F, wa, wb, ...)                          \
  if (wa == 16 && wb == 16) return F<BN, WGS, kTma, kTma>(__VA_ARGS__); \
  if (wa == 16) return F<BN, WGS, kTma, kCopy>(__VA_ARGS__);         \
  if (wb == 16) return F<BN, WGS, kCopy, kTma>(__VA_ARGS__);         \
  return F<BN, WGS, kCopy, kCopy>(__VA_ARGS__);

template <int BN, int WGS>
int launch(const CopySrc& src, void* c, int M, int N, int K, int stages,
           int out_bf16, cudaStream_t stream) {
  TC_DISPATCH_LOADERS(launch_as, src.wa, src.wb, src, c, M, N, K, stages,
                      out_bf16, stream)
}

template <int BN, int WGS>
int occupancy(int wa, int wb, int stages, int* blocks) {
  TC_DISPATCH_LOADERS(occupancy_as, wa, wb, stages, blocks)
}

// one call per (BN, WGS) instantiation: F is launch or occupancy
#define TC_DISPATCH_BN(WGS, F, ...)                \
  switch (bn) {                                    \
    case 8: return F<8, WGS>(__VA_ARGS__);         \
    case 16: return F<16, WGS>(__VA_ARGS__);       \
    case 32: return F<32, WGS>(__VA_ARGS__);       \
    case 64: return F<64, WGS>(__VA_ARGS__);       \
    case 128: return F<128, WGS>(__VA_ARGS__);     \
    case 256: return F<256, WGS>(__VA_ARGS__);     \
  }                                                \
  return (int)cudaErrorInvalidValue;

#define TC_DISPATCH(F, ...)                                 \
  if (bm == 64) { TC_DISPATCH_BN(1, F, __VA_ARGS__) }       \
  if (bm == 128) { TC_DISPATCH_BN(2, F, __VA_ARGS__) }      \
  return (int)cudaErrorInvalidValue;

bool legal(int bm, int bn, int stages) {
  return (bm == 64 || bm == 128) && bn >= 8 && bn <= 256 &&
         (bn & (bn - 1)) == 0 && stages >= 2 && stages <= kMaxStages;
}

}  // namespace

// A (M, K), B (K, N) bf16 row-major, any shape, each on a 2-byte boundary;
// C (M, N) float32 (out_dtype 0) or bfloat16 (1).  An operand whose
// pointer and row stride are on 16 bytes is loaded by TMA, any other by
// the CTA's copies.  bm in {64, 128}; bn a power of two in [8, 256];
// stages in [2, 4] (with one stage the tile of step k + 1 would be loaded
// only after step k + 1 waits on it).  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int matmul_tc(const void* a, const void* b, void* c, int M, int N,
                         int K, int bm, int bn, int stages, int out_dtype,
                         void* stream) {
  if (M < 1 || N < 1 || K < 1 || !legal(bm, bn, stages) ||
      (out_dtype != 0 && out_dtype != 1) ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 2 ||
      reinterpret_cast<uintptr_t>(c) % 8 || (M + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CopySrc src{static_cast<const __nv_bfloat16*>(a),
                    static_cast<const __nv_bfloat16*>(b), copy_width(a, K),
                    copy_width(b, N)};
  TC_DISPATCH(launch, src, c, M, N, K, stages, out_dtype, st)
}

// Resident CTAs per SM that the CUDA runtime reports for the instantiation
// that matmul_tc launches for these operands (a of K columns, b of N).
extern "C" int matmul_tc_occupancy(const void* a, const void* b, int N,
                                   int K, int bm, int bn, int stages,
                                   int* blocks) {
  if (!legal(bm, bn, stages)) return (int)cudaErrorInvalidValue;
  TC_DISPATCH(occupancy, copy_width(a, K), copy_width(b, N), stages, blocks)
}
