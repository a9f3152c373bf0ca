// Nearest-neighbour search for Hopper (sm_90a): for each of nq queries
// (nq, d) the index and squared L2 distance of the nearest of nr refs
// (nr, d), d^2 = |q|^2 - 2 q.r + |r|^2 in f32; ties go to the lowest
// index.
//
// Replaces: src/repro/kernels/nn_search.py::_nn_kernel (the Pallas
// kernel that nn_search_pallas launches at :89), one of the paper's
// "atypical" kernels: a reduction over refs, where lws meets reuse.
//
// Bound on the H100: 2 nq nr d + 3 nq nr FLOPs against (nq + nr) d
// inputs read once, so operations bound it at any real size:
// (2 d + 3) nq nr / 67 TFLOP/s in f32 (the bound counts bf16 inputs at
// the tensor-core rate, which this CUDA-core kernel cannot reach).
//
// Design: a thread owns lws queries (thread t of CTA b takes queries
// b 256 lws + t + 256 j, j < lws), a CTA 256 lws of them; the CTA sweeps
// every ref once, block_r refs at a time staged in shared memory as f32
// (rows zero-padded to whole chunks) with their |r|^2, so a larger lws
// streams the refs through fewer CTAs.  A query's dims are held DC at a
// time in registers (DC = 4, 8, 16 or 32, a template parameter); when d
// spans several chunks, each thread keeps its partial dots over the
// block in shared memory (conflict-free: ref-major, thread-minor).  The
// dot of one chunk runs in four independent accumulators and reads the
// ref four floats at a time (one 16-byte shared load, a broadcast: every
// thread of the warp reads the same ref), so the shared-memory pipe,
// which issues one load a clock against four FMAs, is not the limit.
// Each query's running (min d^2, argmin) lives in a shared-memory slot
// that only its thread reads and writes, initialised to (+inf, 0).  Refs
// are visited in ascending order with a strict "<", within and across
// blocks, which is the lexicographic order on (d^2, index) that the JAX
// kernel's argmin-then-strict-"<" gives.  d^2 is (|q|^2 - 2 s) + |r|^2,
// not sum (q - r)^2, and is not clamped at 0, as in the JAX kernel.
// Bounds are checked: no padded copy of the refs or queries.  Inputs
// fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ __forceinline__ int padded(int d, int dc) {
  return (d + dc - 1) / dc * dc;
}

size_t smem_bytes(int dc, int block_r, int d, int lws) {
  const int dp = padded(d, dc);
  const size_t partial = dp > dc ? (size_t)block_r * kThreads : 0;
  return sizeof(float) * ((size_t)block_r * (dp + 1) + partial) +
         8 * (size_t)kThreads * lws;
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const T* __restrict__ q, const T* __restrict__ r,
          int* __restrict__ idx, float* __restrict__ dist, int nq, int nr,
          int d, int lws, int block_r) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded(d, DC);
  const int nch = dp / DC;
  float* rs = smem;                                  // block_r x dp
  float* rn = rs + block_r * dp;                     // block_r
  float* part = rn + block_r;                        // block_r x 256
  float* best_d = part + (nch > 1 ? block_r * kThreads : 0);  // lws x 256
  int* best_i = reinterpret_cast<int*>(best_d + lws * kThreads);
  const int tid = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * kThreads * lws + tid;

  for (int j = 0; j < lws; ++j) {
    best_d[j * kThreads + tid] = CUDART_INF_F;
    best_i[j * kThreads + tid] = 0;
  }
  for (int r0 = 0; r0 < nr; r0 += block_r) {
    const int nb = min(block_r, nr - r0);
    __syncthreads();  // the previous block's readers are done
    for (int e = tid; e < block_r * dp; e += kThreads) {
      const int rr = e / dp, k = e % dp;
      rs[e] = (rr < nb && k < d) ? to_f32(r[(long long)(r0 + rr) * d + k])
                                 : 0.f;
    }
    __syncthreads();
    for (int rr = tid; rr < nb; rr += kThreads) {
      float s = 0.f;
      for (int k = 0; k < d; ++k)
        s = __fadd_rn(s, __fmul_rn(rs[rr * dp + k], rs[rr * dp + k]));
      rn[rr] = s;
    }
    __syncthreads();
    for (int j = 0; j < lws; ++j) {
      const long long qi = q0 + (long long)j * kThreads;
      if (qi >= nq) break;
      const T* qrow = q + qi * d;
      float qn = 0.f;
      float best = best_d[j * kThreads + tid];
      int bidx = best_i[j * kThreads + tid];
      for (int c = 0; c < nch; ++c) {
        float qv[DC];
#pragma unroll
        for (int kk = 0; kk < DC; ++kk) {
          const int k = c * DC + kk;
          qv[kk] = k < d ? to_f32(qrow[k]) : 0.f;
          qn = __fadd_rn(qn, __fmul_rn(qv[kk], qv[kk]));
        }
        for (int rr = 0; rr < nb; ++rr) {
          // 16-byte aligned: dp and c * DC are multiples of DC >= 4
          const float4* rv =
              reinterpret_cast<const float4*>(rs + rr * dp + c * DC);
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k4 = 0; k4 < DC / 4; ++k4) {
            const float4 v = rv[k4];
            acc[0] = fmaf(qv[4 * k4], v.x, acc[0]);
            acc[1] = fmaf(qv[4 * k4 + 1], v.y, acc[1]);
            acc[2] = fmaf(qv[4 * k4 + 2], v.z, acc[2]);
            acc[3] = fmaf(qv[4 * k4 + 3], v.w, acc[3]);
          }
          float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
          if (c > 0) s += part[rr * kThreads + tid];
          if (c + 1 < nch) {
            part[rr * kThreads + tid] = s;
          } else {
            const float d2 =
                __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, s)), rn[rr]);
            if (d2 < best) {
              best = d2;
              bidx = r0 + rr;
            }
          }
        }
      }
      best_d[j * kThreads + tid] = best;
      best_i[j * kThreads + tid] = bidx;
    }
  }
  for (int j = 0; j < lws; ++j) {
    const long long qi = q0 + (long long)j * kThreads;
    if (qi >= nq) break;
    idx[qi] = best_i[j * kThreads + tid];
    dist[qi] = best_d[j * kThreads + tid];
  }
}

template <typename T>
void* kernel_of(int dc) {
  switch (dc) {
    case 4: return (void*)nn_kernel<T, 4>;
    case 8: return (void*)nn_kernel<T, 8>;
    case 16: return (void*)nn_kernel<T, 16>;
    case 32: return (void*)nn_kernel<T, 32>;
  }
  return nullptr;
}

void* kernel_for(int dtype, int dc) {
  if (dtype == 0) return kernel_of<float>(dc);
  if (dtype == 1) return kernel_of<__nv_bfloat16>(dc);
  return nullptr;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; chunk: 4, 8, 16 or 32 query dims in
// registers.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nn_search(const void* q, const void* r, void* idx, void* dist,
                         int nq, int nr, int d, int lws, int grid,
                         int block_r, int chunk, int dtype, void* stream) {
  void* fn = kernel_for(dtype, chunk);
  if (fn == nullptr || nq < 1 || nr < 1 || d < 1 || lws < 1 || grid < 1 ||
      block_r < 1 || (long long)grid * kThreads * lws < nq)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(chunk, block_r, d, lws);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&q, (void*)&r, &idx, &dist, &nq, &nr,
                  &d, &lws, &block_r};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM that the CUDA runtime reports for the plan's
// instantiation and shared memory.
extern "C" int nn_occupancy(int chunk, int block_r, int d, int lws,
                            int dtype, int* blocks) {
  void* fn = kernel_for(dtype, chunk);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(chunk, block_r, d, lws);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kThreads, smem);
}
