// Flash attention (prefill) for Hopper (sm_90a), grouped-query form.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// Pallas kernel that flash_attention_pallas launches at :101), which the
// JAX package vmaps per (batch, kv group, query head) in
// models/attention.py::pallas_prefill_attention; and the jnp blocked
// sweep tiled_prefill_attention that chunked prefill runs with a traced
// q_offset (models/transformer.py::chunk_prefill_step).  One kernel
// serves both: q_offset is a runtime argument.
//
// Computes out[b, i, g, r] = softmax_k(q[b, i, g, r] . k[b, k, g] * scale)
// @ v[b, k, g] over keys k < Sk, with k <= i + q_offset when causal (the
// query block sitting q_offset positions into the key sequence).
//
// Bound on the H100: at the serving shapes (head_dim 64, prompts of a few
// hundred tokens) the score and value products are ~2 * 2 * Sq * Sk_eff *
// D FLOPs per head against ~2 * Sk * D K/V values read per KV group, so
// operations dominate for long prompts and bytes for short chunks; the
// bound is max(FLOPs / peak, bytes / 3.35 TB/s), with the bf16 tensor-core
// peak (989 TF/s) or, for fp32 inputs, the 67 TF/s CUDA-core peak.  At
// 512 tokens it is under a microsecond: the kernel is bound by latency
// (the chain of dependent steps a warp walks over the keys), not by rate.
//
// Two kernels, one launch geometry: grid (ceil(Sq / block_q), B * G * R),
// a CTA is block_q query rows of one query head; key tiles wholly in a
// tile's causal future are skipped.
//
// bfloat16 (flash_mma_kernel): FlashAttention-2's warp layout on the
// tensor cores, mma.sync.m16n8k16 (bf16 in, f32 out).  Each warp owns 16
// query rows (block_q 32..128: 2..8 warps) and keeps its Q fragments in
// registers.  K and V tiles of block_k rows are staged as bf16 by cp.async,
// double-buffered (the next tile is in flight while this one is used),
// rows padded by 16 bytes so ldmatrix reads them without bank conflicts;
// K is read with ldmatrix, V with ldmatrix.trans.  For each 16 keys a warp
// forms S = Q K^T in f32 fragments, scales and masks them (causal, k < Sk)
// before the exponent, updates the online softmax in registers (row max
// and row sum over the quad by shuffles; fully masked rows kept at m =
// -inf with alpha 0, as the plain version's m_safe), rounds P to bf16 and
// re-packs the S (C-layout) fragments as the A operand of P V with no trip
// through shared memory.  The one change of numerics against the Pallas
// kernel: P is rounded to bf16 for its product with V (the row sums stay
// f32).  head_dim 32, 64 or 128.
//
// float32 (flash_kernel): CUDA cores, one thread a query row, holding its
// scaled query and its f32 accumulator in registers; K/V tiles staged in
// shared memory as f32 and read as broadcasts, the score row of each
// thread in shared memory with an odd stride.  head_dim 64 only.  It keeps
// the fp32 path bit-for-bit what it was (the serving parity check).
//
// Shared memory: bf16 2 * 2 * block_k * (D + 8) * 2 bytes; f32 4 * (2 *
// block_k * D + threads * (block_k + 1)) bytes, threads = round_up(
// block_q, 32).  Accumulation f32; output in the input dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;              // the f32 kernel's head_dim

template <int D>
__global__ void __launch_bounds__(128)
flash_kernel(const float* __restrict__ q,   // (B, Sq, G, R, D)
             const float* __restrict__ k,   // (B, Sk, G, D)
             const float* __restrict__ v,   // (B, Sk, G, D)
             float* __restrict__ out,       // (B, Sq, G, R, D)
             int B, int Sq, int Sk, int G, int R, int block_q, int block_k,
             int q_offset, float scale, int causal) {
  extern __shared__ float smem[];
  float* s_k = smem;                       // (block_k, D)
  float* s_v = s_k + block_k * D;          // (block_k, D)
  float* s_s = s_v + block_k * D;          // (threads, block_k + 1)
  const int tid = threadIdx.x;
  const int bgr = blockIdx.y;
  const int r = bgr % R;
  const int g = (bgr / R) % G;
  const int b = bgr / (R * G);
  const int q0 = blockIdx.x * block_q;
  const int row = q0 + tid;
  const bool active = tid < block_q && row < Sq;
  const int q_pos = row + q_offset;
  const size_t qoff = ((((size_t)b * Sq + row) * G + g) * R + r) * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? q[qoff + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  float* srow = s_s + tid * (block_k + 1);

  // the last key any row of this query tile may attend to
  const int q_last = min(q0 + block_q, Sq) - 1 + q_offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += block_k) {
    for (int e = tid; e < block_k * D; e += blockDim.x) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * G + g) * D + d;
        kv = k[off];
        vv = v[off];
      }
      s_k[e] = kv;
      s_v[e] = vv;
    }
    __syncthreads();
    if (active) {
      float mt = -INFINITY;
      for (int j = 0; j < block_k; ++j) {
        const int kp = k0 + j;
        float s = -INFINITY;
        if (kp < Sk && (!causal || kp <= q_pos)) {
          const float* kr = s_k + j * D;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
          s = dot;
        }
        srow[j] = s;
        mt = fmaxf(mt, s);
      }
      const float m_new = fmaxf(m, mt);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      const float alpha = isinf(m) ? 0.f : expf(m - m_safe);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
      for (int j = 0; j < block_k; ++j) {
        const float s = srow[j];
        if (isinf(s)) continue;
        const float p = expf(s - m_safe);
        l += p;
        const float* vr = s_v + j * D;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += p * vr[d];
      }
      m = m_new;
    }
    __syncthreads();
  }
  if (active) {
    const float lsafe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) out[qoff + d] = acc[d] / lsafe;
  }
}

// --------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync.m16n8k16)
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, row) b (16 x 8, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(256)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,   // (B, Sq, G, R, D)
                 const __nv_bfloat16* __restrict__ k,   // (B, Sk, G, D)
                 const __nv_bfloat16* __restrict__ v,   // (B, Sk, G, D)
                 __nv_bfloat16* __restrict__ out,       // (B, Sq, G, R, D)
                 int B, int Sq, int Sk, int G, int R, int block_k,
                 int q_offset, float scale, int causal) {
  constexpr int LD = D + 8;                // padded smem row, in bf16
  constexpr int CH = D / 8;                // 16-byte chunks of a row
  extern __shared__ __align__(16) __nv_bfloat16 kv[];  // [2][K, V][bk][LD]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int block_q = blockDim.x / 2;      // 16 rows a warp
  const int bgr = blockIdx.y;
  const int r = bgr % R;
  const int g = (bgr / R) % G;
  const int b = bgr / (R * G);
  const int q0 = blockIdx.x * block_q;
  const int qr = lane / 4, qc = 2 * (lane % 4);   // fragment row / column
  const int row_a = q0 + warp * 16 + qr, row_b = row_a + 8;
  const int pos_a = row_a + q_offset, pos_b = row_b + q_offset;

  auto q_at = [&](int row, int col) -> uint32_t {
    if (row >= Sq) return 0u;
    return *reinterpret_cast<const uint32_t*>(
        q + ((((size_t)b * Sq + row) * G + g) * R + r) * D + col);
  };
  uint32_t qf[D / 16][4];                  // A fragments of the warp's Q
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qf[ks][0] = q_at(row_a, 16 * ks + qc);
    qf[ks][1] = q_at(row_b, 16 * ks + qc);
    qf[ks][2] = q_at(row_a, 16 * ks + qc + 8);
    qf[ks][3] = q_at(row_b, 16 * ks + qc + 8);
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  const int q_last = min(q0 + block_q, Sq) - 1 + q_offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int warp_last = min(q0 + warp * 16 + 15, Sq - 1) + q_offset;
  const int ntiles = (k_end + block_k - 1) / block_k;

  auto stage = [&](int t, int buf) {       // key tile t -> buffer buf
    __nv_bfloat16* ks = kv + (size_t)buf * 2 * block_k * LD;
    __nv_bfloat16* vs = ks + (size_t)block_k * LD;
    for (int e = tid; e < block_k * CH; e += blockDim.x) {
      const int j = e / CH, c = e % CH;
      const int kp = t * block_k + j;
      const bool ok = kp < Sk;
      const size_t off =
          ok ? ((((size_t)b * Sk + kp) * G + g) * D + c * 8) : 0;
      cp_async16(ks + j * LD + c * 8, k + off, ok);
      cp_async16(vs + j * LD + c * 8, v + off, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (ntiles > 0) stage(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      stage(t + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv + (size_t)buf * 2 * block_k * LD;
    const __nv_bfloat16* vs = ks + (size_t)block_k * LD;
    for (int kk = 0; kk < block_k; kk += 16) {
      const int kp0 = t * block_k + kk;
      if (kp0 >= k_end) break;
      if (causal && kp0 > warp_last) break;   // the warp's causal future
      // S = Q K^T over keys kp0 .. kp0 + 15: two 16 x 8 fragments
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int mi = lane / 8, mr = lane % 8;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (kk + (mi / 2) * 8 + mr) * LD + 16 * kd +
                            (mi % 2) * 8);
        mma16816(s[0], qf[kd], bk[0], bk[1]);
        mma16816(s[1], qf[kd], bk[2], bk[3]);
      }
      // scale and mask before the exponent; each thread's row maxima
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kp0 + 8 * j + qc + (e & 1);
          const int qp = e < 2 ? pos_a : pos_b;
          float x = s[j][e] * scale;
          if (kp >= Sk || (causal && kp > qp)) x = -INFINITY;
          s[j][e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
        }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float ms_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float ms_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = m_a == -INFINITY ? 0.f : __expf(m_a - ms_a);
      const float al_b = m_b == -INFINITY ? 0.f : __expf(m_b - ms_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float p =
              x == -INFINITY ? 0.f : __expf(x - (e < 2 ? ms_a : ms_b));
          s[j][e] = p;
          if (e < 2) sum_a += p; else sum_b += p;
        }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= al_a;
        o[n][1] *= al_a;
        o[n][2] *= al_b;
        o[n][3] *= al_b;
      }
      // P (C layout of the two fragments) is the A operand of P V
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk + (mi % 2) * 8 + mr) * LD +
                                  (n + mi / 2) * 8);
        mma16816(o[n], pa, bv[0], bv[1]);
        mma16816(o[n + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                       // the buffer is staged again next
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + qc;
    if (row_a < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((((size_t)b * Sq + row_a) * G + g) * R + r) * D + col) =
          __floats2bfloat162_rn(o[n][0] * inv_a, o[n][1] * inv_a);
    if (row_b < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((((size_t)b * Sq + row_b) * G + g) * R + r) * D + col) =
          __floats2bfloat162_rn(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int Sq, int Sk, int G, int R, int block_q, int block_k,
               int q_offset, float scale, int causal, cudaStream_t stream) {
  const int threads = (block_q + 31) / 32 * 32;
  const size_t smem =
      sizeof(float) * (2 * (size_t)block_k * D + (size_t)threads * (block_k + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + block_q - 1) / block_q, B * G * R);
  flash_kernel<D><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), B, Sq, Sk, G,
      R, block_q, block_k, q_offset, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int G, int R, int block_q,
                int block_k, int q_offset, float scale, int causal,
                cudaStream_t stream) {
  const size_t smem = 2 * 2 * (size_t)block_k * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + block_q - 1) / block_q, B * G * R);
  flash_mma_kernel<D><<<grid, block_q * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      B, Sq, Sk, G, R, block_k, q_offset, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (D 64, block_q 1..128), 1 = bfloat16 (D 32, 64 or
// 128; block_q a multiple of 16 in 16..128; block_k a multiple of 16;
// 16-byte-aligned pointers).  causal: 1 masks k > i + q_offset.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int G, int R,
                               int D, int block_q, int block_k, int q_offset,
                               float scale, int causal, int dtype,
                               void* stream) {
  if (block_q < 1 || block_q > 128 || block_k < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D != kHeadDim) return (int)cudaErrorInvalidValue;
    return launch_f32<kHeadDim>(q, k, v, out, B, Sq, Sk, G, R, block_q,
                                block_k, q_offset, scale, causal, st);
  }
  if (dtype != 1 || block_q % 16 != 0 || block_k % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch_bf16<32>(q, k, v, out, B, Sq, Sk, G, R, block_q, block_k,
                             q_offset, scale, causal, st);
    case 64:
      return launch_bf16<64>(q, k, v, out, B, Sq, Sk, G, R, block_q, block_k,
                             q_offset, scale, causal, st);
    case 128:
      return launch_bf16<128>(q, k, v, out, B, Sq, Sk, G, R, block_q,
                              block_k, q_offset, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
