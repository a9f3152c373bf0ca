// float32 matmul on Hopper's tensor cores as 3xTF32: a split pass into
// TF32 big and small halves, then TMA loads into a ring of shared-memory
// stages and wgmma products with f32 accumulators in registers (sm_90a).
//
// Replaces: src/repro/kernels/matmul.py::_matmul_kernel (the Pallas
// kernel that matmul_pallas launches at :66) for float32 operands.  The
// Pallas kernel casts both operands to f32 and accumulates in f32.  One
// TF32 product keeps 10 of an operand's 23 mantissa bits: at K = 4096 its
// error on O(1) outputs is ~1e-3, ten times the f32 tolerance.  So each
// operand is split, x = big + small, big = x rounded to TF32
// (cvt.rna.tf32.f32, ties away from zero), small = the TF32 rounding of
// x - big, and the product is the sum of three TF32 products,
// a_small b_big + a_big b_small + a_big b_big (a_small b_small, ~2^-22
// of the product, is dropped): about 21 bits of each operand, f32
// accuracy.  Finite inputs give finite partial products; an infinite or
// NaN input keeps small = 0, and an output that meets an infinity is NaN
// wherever the infinity multiplies a zero part or parts of both signs
// (the other operand's small part is 0 for a TF32-exact value and has
// the sign opposite its big part when big rounded up), where the exact
// f32 product may be +-inf.
//
// Bound on the H100: 3 x 2 M N K TF32 operations against (M K + K N) f32
// read and M N written; at 4096^3 that is 412 GFLOP over 495 TF/s, 0.833
// ms, far above the bytes' 0.06 ms, so operations bound it.  The
// CUDA-core kernel this replaced reached a third of the f32 CUDA-core
// rate (67 TF/s), cuBLAS's SGEMM 78% of it; the TF32 tensor cores give a
// 3xTF32 ceiling of 165 TF/s.
//
// Design.  wgmma takes TF32 operands K-major only (there is no transpose
// for .tf32), and B arrives (K, N) row-major, MN-major.  So:
//  * the split pass (tf32x3_split) reads A (M, K) and B (K, N) once and
//    writes four padded workspaces, A_big and A_small (M, Kp) and
//    B_big^T and B_small^T (Np, Kp), all K-major, K padded with zeros to
//    Kp (a multiple of 32) and N to Np (a multiple of the tile's BN).  B
//    is transposed through a 32 x 33 shared-memory tile so reads and
//    writes both run along rows.  The padding lets the product use TMA
//    whatever the caller's shape or alignment.
//  * the product (tf32x3_product) is csrc/matmul_tc.cu's pipeline: a CTA
//    owns a BM x BN output tile, BM = 64 WGS for WGS = 1 or 2 consumer
//    warpgroups, BN in {8, ..., 128}; K is swept in steps of 32 f32 (128
//    bytes, one 128-byte swizzle row).  Thread 0 keeps a ring of `stages`
//    (2 to 4) stages filled by TMA, each four K-major boxes (A big and
//    small, BM rows; B big and small, BN rows; 128B swizzle), completion
//    counted on the stage's `full` mbarrier, a stage refilled once every
//    warpgroup has arrived on its `empty` mbarrier.  Per K step each
//    warpgroup issues, for each of the four k8 slices, the three
//    wgmma.m64nBNk8.f32.tf32.tf32 products, small ones first, into a
//    fresh partial, commits and waits for them, while TMA fills the
//    stages ahead.
//  * the tensor cores add into their accumulator with truncation, and
//    its bias grows with the additions into one register (1,536 at K =
//    4096) far past f32's round-to-nearest error.  So a K step's partial
//    (96 products an output) is added to the f32 sum on the CUDA cores,
//    rounding to nearest, once the step has finished: a wait every step,
//    the price of f32 accuracy; more steps a partial trade accuracy for
//    fewer waits.  A thread holds BN f32 for the two, hence BN <= 128.
//    The epilogue stores the sums with the edges masked; TMA fills rows
//    past M with zeros.
// The TMA descriptors are encoded on the host for each call
// (cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint so no
// -lcuda is needed) and passed as __grid_constant__ parameters; the TMA,
// mbarrier and wgmma helpers are csrc/tma_wgmma.cuh's, shared with
// csrc/matmul_tc.cu and csrc/nn_search.cu; the split's rounding is
// csrc/tf32_split.cuh's, shared with csrc/nn_search.cu.
//
// Takes: A (M, K) and B (K, N) row-major float32 (any 4-byte-aligned
// pointers); C (M, N) float32 or bfloat16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "smem_optin.cuh"
#include "tf32_split.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace tma_wgmma;
using tf32_split::split_store;

constexpr int kBK = 32;            // K step: 128 bytes of f32
constexpr int kMaxStages = 4;
constexpr int kWG = 128;           // threads of a warpgroup
constexpr int kTile = 32;          // split pass: 32 x 32 tiles
constexpr int kSplitThreads = 256; // 32 columns x 8 rows

// ------------------------------------------------------------------ split

// One CTA a 32 x 32 tile: the first a_tiles CTAs tile A (M, Kp), the rest
// tile B^T (Np, Kp).  Reads past K or N are zeros.
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ a_ws, float* __restrict__ b_ws, int M,
             int N, int K, int Np, int Kp, int a_tiles) {
  __shared__ float tile[kTile][kTile + 1];
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int kt = Kp / kTile;
  int t = blockIdx.x;
  float v[kTile / 8];
  if (t < a_tiles) {
    const int r0 = (t / kt) * kTile, c = (t % kt) * kTile + tx;
    float* big = a_ws;
    float* small = a_ws + (size_t)M * Kp;
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int r = r0 + ty + 8 * i;
      v[i] = (r < M && c < K) ? A[(size_t)r * K + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int r = r0 + ty + 8 * i;
      const size_t o = (size_t)r * Kp + c;
      if (r < M) split_store(v[i], big + o, small + o);
    }
    return;
  }
  t -= a_tiles;                            // uniform across the CTA
  const int n0 = (t / kt) * kTile, k0 = (t % kt) * kTile;
  float* big = b_ws;
  float* small = b_ws + (size_t)Np * Kp;
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) {
    const int k = k0 + ty + 8 * i, n = n0 + tx;
    v[i] = (k < K && n < N) ? B[(size_t)k * N + n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) tile[ty + 8 * i][tx] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) {
    const int n = n0 + ty + 8 * i, k = k0 + tx;
    const size_t o = (size_t)n * Kp + k;
    if (n < Np) split_store(tile[tx][ty + 8 * i], big + o, small + o);
  }
}

// ---------------------------------------------------------------- product

// wgmma descriptor of a K-major tile with 128-byte swizzle: 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return desc(addr, 16, 1024, 1);
}

// D(64 x N, f32) = A(64 x 8, K-major) B(8 x N, K-major) (+ D unless
// scale_d is 0), TF32 inputs
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db,
                                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<16>(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
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
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
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

template <int BN, int WGS>
__global__ void __launch_bounds__(kWG * WGS, 1)
tf32x3_kernel(const __grid_constant__ CUtensorMap tma_ab,
              const __grid_constant__ CUtensorMap tma_as,
              const __grid_constant__ CUtensorMap tma_bb,
              const __grid_constant__ CUtensorMap tma_bs,
              void* __restrict__ C, int M, int N, int Kp, int stages,
              int out_bf16) {
  constexpr int BM = 64 * WGS;
  constexpr int kATile = BM * kBK * 4;      // bytes of one A tile
  constexpr int kBTile = BN * kBK * 4;
  constexpr int kStage = 2 * kATile + 2 * kBTile;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles sit on 1024-byte boundaries (the swizzle atom); every
  // tile is a multiple of 1024 bytes
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStage);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = Kp / kBK;

  // K tile t into stage s: A big | A small | B big | B small
  auto load = [&](int t, int s) {
    uint8_t* st = smem + s * kStage;
    mbar_expect_tx(&full[s], kStage);
    tma_load(st, &tma_ab, t * kBK, row0, &full[s]);
    tma_load(st + kATile, &tma_as, t * kBK, row0, &full[s]);
    tma_load(st + 2 * kATile, &tma_bb, t * kBK, col0, &full[s]);
    tma_load(st + 2 * kATile + kBTile, &tma_bs, t * kBK, col0, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < stages && t < KT; ++t) load(t, t);

  // each K step's products go to a fresh partial (scale-d 0 on its first
  // wgmma), which is added to sum with f32 round-to-nearest once the step
  // has finished
  float part[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;

  for (int k = 0; k < KT; ++k) {
    const int s = k % stages;
    mbar_wait(&full[s], (k / stages) & 1);
    const uint32_t ab = smem_u32(smem + s * kStage) + wg * 64 * 128;
    const uint32_t as = ab + kATile;
    const uint32_t bb = smem_u32(smem + s * kStage + 2 * kATile);
    const uint32_t bs = bb + kBTile;
    fence_regs<BN / 2>(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {   // k8 slices, 32 bytes apart
      const uint32_t o = kk * 32;
      wgmma<BN>(part, desc128(as + o), desc128(bb + o), kk > 0);
      wgmma<BN>(part, desc128(ab + o), desc128(bs + o), 1);
      wgmma<BN>(part, desc128(ab + o), desc128(bb + o), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BN / 2>(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] += part[i];
    if (tid % kWG == 0) mbar_arrive(&empty[s]);   // stage s is free
    if (tid == 0 && k + stages < KT) {
      mbar_wait(&empty[s], (k / stages) & 1);
      load(k + stages, s);
    }
    __syncwarp();
  }

  // accumulator fragment: register 4 j + 2 h + e holds row
  // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const int lane = tid % 32, warp = (tid % kWG) / 32;
  const int r_lo = row0 + wg * 64 + warp * 16 + lane / 4;
  const bool pairs = N % 2 == 0;           // col even: col + 1 < N too
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + 8 * h;
      if (row >= M) continue;
      const size_t o = (size_t)row * N + col;
      const float x = sum[4 * j + 2 * h], y = sum[4 * j + 2 * h + 1];
      if (out_bf16) {
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(C) + o;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
        } else {
          p[0] = __float2bfloat16(x);
          if (col + 1 < N) p[1] = __float2bfloat16(y);
        }
      } else {
        float* p = static_cast<float*>(C) + o;
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(x, y);
        } else {
          p[0] = x;
          if (col + 1 < N) p[1] = y;
        }
      }
    }
  }
}

// a K-major f32 workspace (rows, kp) read in (box_rows, 32) boxes, 128B
// swizzle
bool encode(CUtensorMap* map, const float* ptr, int rows, int kp,
            int box_rows) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t smem_bytes(int bm, int bn, int stages) {
  return (size_t)stages * (bm + bn) * kBK * 4 * 2 + 2 * kMaxStages * 8 +
         1024;
}

template <int BN, int WGS>
cudaError_t allow_smem() {
  static std::atomic<unsigned> devices{0};
  return smem_optin::allow((const void*)tf32x3_kernel<BN, WGS>, devices);
}

template <int BN, int WGS>
int launch(const float* a_ws, const float* b_ws, void* c, int M, int N,
           int Np, int Kp, int stages, int out_bf16, cudaStream_t stream) {
  constexpr int BM = 64 * WGS;
  cudaError_t err = allow_smem<BN, WGS>();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tab, tas, tbb, tbs;
  if (!encode(&tab, a_ws, M, Kp, BM) ||
      !encode(&tas, a_ws + (size_t)M * Kp, M, Kp, BM) ||
      !encode(&tbb, b_ws, Np, Kp, BN) ||
      !encode(&tbs, b_ws + (size_t)Np * Kp, Np, Kp, BN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Np / BN, (M + BM - 1) / BM);
  tf32x3_kernel<BN, WGS><<<grid, kWG * WGS, smem_bytes(BM, BN, stages),
                           stream>>>(tab, tas, tbb, tbs, c, M, N, Kp,
                                     stages, out_bf16);
  return (int)cudaGetLastError();
}

template <int BN, int WGS>
int occupancy(int stages, int* blocks) {
  cudaError_t err = allow_smem<BN, WGS>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tf32x3_kernel<BN, WGS>, kWG * WGS,
      smem_bytes(64 * WGS, BN, stages));
}

// one call per (BN, WGS) instantiation: F is launch or occupancy
#define TF32_DISPATCH_BN(WGS, F, ...)              \
  switch (bn) {                                    \
    case 8: return F<8, WGS>(__VA_ARGS__);         \
    case 16: return F<16, WGS>(__VA_ARGS__);       \
    case 32: return F<32, WGS>(__VA_ARGS__);       \
    case 64: return F<64, WGS>(__VA_ARGS__);       \
    case 128: return F<128, WGS>(__VA_ARGS__);     \
  }                                                \
  return (int)cudaErrorInvalidValue;

#define TF32_DISPATCH(F, ...)                                 \
  if (bm == 64) { TF32_DISPATCH_BN(1, F, __VA_ARGS__) }       \
  if (bm == 128) { TF32_DISPATCH_BN(2, F, __VA_ARGS__) }      \
  return (int)cudaErrorInvalidValue;

// BN <= 128: a thread holds BN f32 (the partial and the sum)
bool legal(int bm, int bn, int stages) {
  return (bm == 64 || bm == 128) && bn >= 8 && bn <= 128 &&
         (bn & (bn - 1)) == 0 && stages >= 2 && stages <= kMaxStages;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The split pass.  A (M, K), B (K, N) row-major float32; a_ws holds
// A_big then A_small, each (M, Kp); b_ws B_big^T then B_small^T, each
// (Np, Kp); Kp a multiple of 32 at least K, Np a multiple of 8 at least
// N.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tf32x3_split(const void* a, const void* b, void* a_ws,
                            void* b_ws, int M, int N, int K, int Np, int Kp,
                            void* stream) {
  if (M < 1 || N < 1 || K < 1 || Kp < K || Kp % kTile != 0 || Np < N ||
      Np % 8 != 0 || !aligned16(a_ws) || !aligned16(b_ws) ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 4)
    return (int)cudaErrorInvalidValue;
  const long long kt = Kp / kTile;
  const long long a_tiles = (long long)((M + kTile - 1) / kTile) * kt;
  const long long tiles = a_tiles + (long long)((Np + kTile - 1) / kTile) * kt;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  split_kernel<<<(unsigned)tiles, kSplitThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(a_ws), static_cast<float*>(b_ws), M, N, K, Np, Kp,
      (int)a_tiles);
  return (int)cudaGetLastError();
}

// The product.  a_ws and b_ws as tf32x3_split wrote them; C (M, N)
// float32 (out_dtype 0) or bfloat16 (1).  bm in {64, 128}; bn a power of
// two in [8, 128] dividing Np; stages in [2, 4] (with one stage the tile
// of step k + 1 would be loaded only after step k + 1 waits on it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tf32x3_product(const void* a_ws, const void* b_ws, void* c,
                              int M, int N, int Np, int Kp, int bm, int bn,
                              int stages, int out_dtype, void* stream) {
  if (M < 1 || N < 1 || Np < N || Kp < kBK || Kp % kBK != 0 ||
      !legal(bm, bn, stages) || Np % bn != 0 || !aligned16(a_ws) ||
      !aligned16(b_ws) || reinterpret_cast<uintptr_t>(c) % 8 ||
      (out_dtype != 0 && out_dtype != 1) ||
      (M + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
  const float* aw = static_cast<const float*>(a_ws);
  const float* bw = static_cast<const float*>(b_ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TF32_DISPATCH(launch, aw, bw, c, M, N, Np, Kp, stages, out_dtype, st)
}

// Resident CTAs per SM that the CUDA runtime reports for one
// instantiation of the product.
extern "C" int tf32x3_occupancy(int bm, int bn, int stages, int* blocks) {
  if (!legal(bm, bn, stages)) return (int)cudaErrorInvalidValue;
  TF32_DISPATCH(occupancy, stages, blocks)
}
