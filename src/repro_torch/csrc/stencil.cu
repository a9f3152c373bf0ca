// Separable Gaussian blur, two passes over an (h, w) image, for Hopper
// (sm_90a): a row pass along the width, then a column pass along the
// height, each with zero ("same") padding at the image's edges.
//
// Replaces: src/repro/kernels/stencil.py::_row_pass_kernel (the Pallas
// kernel that gaussian_blur_pallas launches at :98) and
// ::_col_pass_kernel (:106), the paper's "atypical" stencil.
//
// Bound on the H100: 2 ksize FLOPs per pixel and pass against 2 pixels
// moved (read once, written once), far below the CUDA cores' rate, so
// bytes bound each pass: 2 h w sizeof(T) / 3.35 TB/s.  A pass is a copy
// with a few taps, and what sets its time is the bytes a multiprocessor
// keeps in flight.
//
// Design: a CTA of 256 threads owns a strip of columns and streams down
// (or up) a block of `rows` rows of it, through a ring of row slots in
// shared memory.  A thread loads V columns of each row: on the vector
// route one 16-byte vector (V = 4 f32 or 8 bf16; rows whole vectors, the
// image on 16 bytes), so a warp loads 512 contiguous bytes of a row; on
// the scalar route one column (V = 1), any width or alignment.  The grid
// is 1-D, the strips of a row block consecutive (CTA b: row block b /
// strips, strip b % strips), so the CTAs that run together read whole
// rows of the image.  Each thread keeps `depth` rows in flight ahead of
// the row whose taps run: by cp.async straight into the ring where an
// element group is 4 or 16 bytes, or (bf16 scalars, 2 bytes, which
// cp.async does not copy) by loads into `depth` registers stored into the
// ring when their row comes up.  No CTA stages its whole tile first.
//  * Column pass: two rows in flight on the vector route (eight f32 or
//    four bf16 scalars on the scalar route); the ring holds the ksize rows under the current output and
//    the rows in flight, ksize + depth - 1 slots (a row lands in the slot
//    of the first row of the output just computed), 24 KB at ksize 5, so
//    8 CTAs fit on an SM.  Each thread reads only its own column's
//    slots: no barrier; it reads its own 16-byte vector a tap and stores
//    the output as one vector.  The halo rows above and below the block
//    come from the same stream, zero off the image (cp.async's zero
//    fill).  Even row blocks stream down and odd ones up, so two
//    neighbours read the halo rows between them at about the same time,
//    once from memory and once from L2, where a block reading its halo
//    rows at its start and its neighbour reading them at its end would
//    fetch them twice (ksize - 1 rows of every `rows`).  A block whose
//    inputs all fit in the rows in flight (NAIVE's one row) streams down;
//    on the f32 scalar route it issues them in one batch and waits once.
//  * Row pass: four rows in flight on the vector route (eight f32 or four
//    bf16 scalars on the scalar route), depth + 1 slots, each row with ceil(halo / V) halo vectors
//    on each side, one barrier a row.  A thread computes the V outputs at
//    columns t, t + 256, ..., t + 256 (V - 1) of the strip, so the tap
//    reads of a warp fall on consecutive words, free of bank conflicts (a
//    thread reading its own vector's neighbours would stride V words), at
//    constant offsets from one pointer; its stores are coalesced 4- or
//    2-byte stores.
// No division or modulo runs per element: the strip, the block and the
// ring's slots are computed once per CTA and advanced by adds.
// What the first design did, and what this one does about it:
//  1. It staged a CTA's whole lws x 256 tile in shared memory as f32, so
//     residency fell as Eq. 1's lws grew (3 CTAs an SM at AUTO's lws 63).
//     Here a CTA holds a ring of a few row slots whatever lws is: 8 CTAs
//     of 256 threads an SM at ksize 5.
//  2. A CTA loaded its whole tile, waited, then computed, so loads and
//     taps never overlapped within it.  Here `depth` rows are in flight
//     while the current row's taps run.
//  3. Every load was a scalar, with a division and a modulo by a runtime
//     pitch per element.  Here loads are 16-byte vectors on the vector
//     route, and offsets come from threadIdx and the strip.
//  4. AUTO's 1,056 CTAs took 2.67 waves at 3 an SM.  Here the plan takes
//     ceil(lws / V) rows a thread: at 4096^2 f32, 1,024 CTAs, one wave at
//     8 an SM.
// Arithmetic (both routes, both passes): f32 taps from the host, the sum
// over the taps in order, acc = acc + tap * x with each operation rounded
// (no fused multiply-add), one rounding to the image's dtype per pass, as
// the plain version computes; the column pass reads the row pass's
// image-dtype intermediate, as the JAX row pass writes it.  Inputs fp32
// or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a CTA: 256 threads
constexpr int kMaxTaps = 64;

struct Taps {
  float c[kMaxTaps];
};

// A thread's V elements as one load: 16, 4 or 2 bytes.
template <int B>
struct RawBytes;
template <>
struct RawBytes<16> {
  using type = uint4;
};
template <>
struct RawBytes<4> {
  using type = unsigned int;
};
template <>
struct RawBytes<2> {
  using type = unsigned short;
};
template <typename T, int V>
using Raw = typename RawBytes<V * sizeof(T)>::type;

// cp.async copies 4, 8 or 16 bytes; bf16 scalars go through registers.
template <typename T, int V>
__host__ __device__ constexpr bool async_copy() {
  return V * sizeof(T) >= 4;
}

// Rows a thread keeps in flight (Pass 0: the row pass, 1: the column
// pass): on the vector route four in the row pass and two in the column
// pass, whose ring (ksize + depth - 1 rows of the strip) then lets 8 CTAs
// sit on an SM at ksize 5; eight f32 scalars; four bf16 scalars (in
// registers).
template <int Pass, typename T, int V>
__host__ __device__ constexpr int depth() {
  return V > 1 ? (Pass == 0 ? 4 : 2) : async_copy<T, V>() ? 8 : 4;
}

// Resident CTAs an SM the registers must allow: 8 (32 registers), or 6
// (40) where bf16 scalars are staged in registers.
template <typename T, int V>
__host__ __device__ constexpr int min_ctas() {
  return async_copy<T, V>() ? 8 : 6;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One element group from global to shared memory by cp.async; zeros when
// !ok (no byte is read).
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename R>
__device__ __forceinline__ R load(const void* p, bool ok) {
  return ok ? __ldg(static_cast<const R*>(p)) : R{};
}

// Element j of a group as f32, and V sums rounded to T as a group: bit
// casts for one element, so no group is given an address.
template <typename T, int V>
__device__ __forceinline__ float elem(const Raw<T, V>& r, int j) {
  if constexpr (V > 1)
    return to_f32(reinterpret_cast<const T*>(&r)[j]);
  else if constexpr (sizeof(T) == 4)
    return __uint_as_float(r);
  else
    return __bfloat162float(__ushort_as_bfloat16(r));
}
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> pack(const float (&acc)[V]) {
  Raw<T, V> o;
  if constexpr (V > 1) {
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < V; ++j) store(oe + j, acc[j]);
  } else if constexpr (sizeof(T) == 4) {
    o = __float_as_uint(acc[0]);
  } else {
    o = __bfloat16_as_ushort(__float2bfloat16(acc[0]));
  }
  return o;
}

// The row pass's V outputs of one row at columns c0 + e 256 (e < V) from
// sp, the slot's element under output 0's first tap; dst: output 0.
template <typename T, int V>
__device__ __forceinline__ void row_outputs(const T* sp, const float* coef,
                                            int ksize, T* dst, int c0,
                                            int w) {
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  for (int k = 0; k < ksize; ++k) {
    const float c = coef[k];
#pragma unroll
    for (int e = 0; e < V; ++e)
      acc[e] = __fadd_rn(acc[e], __fmul_rn(c, to_f32(sp[e * kThreads + k])));
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (c0 + e * kThreads < w) store(dst + e * kThreads, acc[e]);
}

// The column pass's output from a thread's ring (slot q at ring[q 256]),
// its top row in slot q and the taps stepping gs slots (wrapping).
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> col_output(const Raw<T, V>* ring, int q,
                                                int gs, int slots,
                                                const float* coef,
                                                int ksize) {
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  for (int k = 0; k < ksize; ++k) {
    const Raw<T, V> v = ring[q * kThreads];
    const float c = coef[k];
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(c, elem<T, V>(v, j)));
    q += gs;
    if (q == slots) q = 0;
    else if (q < 0) q = slots - 1;
  }
  return pack<T, V>(acc);
}

// Thread 0 copies the taps to shared memory with static indices, so the
// parameter struct is never indexed at run time.  The caller's barrier
// comes after its first loads are issued: the copy overlaps their trip.
__device__ __forceinline__ void copy_taps(const Taps& taps, float* dst) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) dst[i] = taps.c[i];
  }
}

// A thread's loads into ring slots, D rows in flight: by cp.async, or
// into D registers (stage d holds the row issued at a step d mod D)
// stored into the row's slot when its step comes.
template <typename T, int V, int D>
struct Stream {
  using R = Raw<T, V>;
  R reg[async_copy<T, V>() ? 1 : D];

  __device__ __forceinline__ void issue(int d, R* dst, const T* src,
                                        bool ok) {
    if constexpr (async_copy<T, V>())
      copy_async<sizeof(R)>(dst, src, ok);
    else
      reg[d] = load<R>(src, ok);
  }
  __device__ __forceinline__ void land(int d, R* dst) {
    if constexpr (!async_copy<T, V>()) *dst = reg[d];
  }
  // every row issued before the last D - 1 has landed
  __device__ __forceinline__ void wait() {
    if constexpr (async_copy<T, V>()) wait_rows<D - 1>();
  }
  __device__ __forceinline__ void done() {
    if constexpr (async_copy<T, V>()) commit();
  }
};

// CTA b: row block b / strips of strip b % strips, so the CTAs running
// together cover whole rows of the image.
__device__ __forceinline__ void cta_tile(int strips, int rows, int& strip,
                                         int& rb, long long& row0) {
  rb = blockIdx.x / strips;
  strip = blockIdx.x - rb * strips;
  row0 = (long long)rb * rows;
}

// Runs step(i, d) for i = 0 .. n - 1.  The register path unrolls the
// steps by D, so that stage d = i mod D is a constant; cp.async needs no
// stage, and its steps stay one loop.
template <typename T, int V, int D, typename Step>
__device__ __forceinline__ void for_steps(int n, Step&& step) {
  if constexpr (async_copy<T, V>()) {
    for (int i = 0; i < n; ++i) step(i, 0);
  } else {
    for (int i0 = 0; i0 < n; i0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (i0 + d >= n) break;
        step(i0 + d, d);
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, min_ctas<T, V>())
row_pass_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w,
                int rows, int strips, int ksize, Taps taps) {
  using R = Raw<T, V>;
  constexpr int kD = depth<0, T, V>();
  constexpr int kSlots = kD + 1;
  extern __shared__ uint4 smem[];
  __shared__ float coef[kMaxTaps];
  copy_taps(taps, coef);  // read after the first step's barrier
  R* ring = reinterpret_cast<R*>(smem);  // slot s: ring[s * nv ...]
  int strip, rb;
  long long row0;
  cta_tile(strips, rows, strip, rb, row0);
  const int nout = (int)min((long long)rows, h - row0);
  const int halo = (ksize - 1) / 2;
  const int hv = (halo + V - 1) / V;  // halo vectors on each side
  const int nv = kThreads + 2 * hv;   // vectors of a row slot
  const int t = threadIdx.x;
  // Slot vector k holds the image's vector strip * 256 - hv + k.  Thread
  // t loads vector t of each row (column ca) and, for t < 2 hv, vector
  // 256 + t (column cb); src points at the next row to issue.
  const int ca = (strip * kThreads - hv + t) * V;
  const int cb = (strip * kThreads - hv + kThreads + t) * V;
  const bool oka = ca >= 0 && ca < w;
  const bool hb = t < 2 * hv;
  const bool okb = hb && cb < w;
  const T* src = x + row0 * w;
  Stream<T, V, kD> sa, sb;
  auto issue = [&](int d, R* slot) {
    sa.issue(d, slot + t, src + (oka ? ca : 0), oka);
    if (hb) sb.issue(d, slot + kThreads + t, src + (okb ? cb : 0), okb);
  };
  // The thread's outputs: columns c0 + e 256 of the strip, e < V; tap k
  // of output e reads element t + e 256 + k + hv V - halo of the slot.
  const int c0 = strip * kThreads * V + t;
  T* dst = out + row0 * w + c0;
  const int first = t + hv * V - halo;  // output 0's first tap in a slot
  for_steps<T, V, kD>(kD, [&](int r, int d) {  // rows 0 .. kD - 1
    if (r < nout) issue(d, ring + r * nv);
    sa.done();
    src += w;
  });
  int s = 0;  // the slot of row r
  for_steps<T, V, kD>(nout, [&](int r, int d) {
    R* slot = ring + s * nv;
    sa.wait();
    sa.land(d, slot + t);
    if (hb) sb.land(d, slot + kThreads + t);
    __syncthreads();
    row_outputs<T, V>(reinterpret_cast<const T*>(slot) + first, coef, ksize,
                      dst, c0, w);
    dst += w;
    // row r + kD into the slot of row r - 1, which every thread has read
    // before the barrier above
    if (r + kD < nout) issue(d, ring + (s == 0 ? kSlots - 1 : s - 1) * nv);
    sa.done();
    src += w;
    s = s + 1 == kSlots ? 0 : s + 1;
  });
  wait_rows<0>();
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, min_ctas<T, V>())
col_pass_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w,
                int rows, int strips, int ksize, Taps taps) {
  using R = Raw<T, V>;
  constexpr int kD = depth<1, T, V>();
  extern __shared__ uint4 smem[];
  __shared__ float coef[kMaxTaps];
  copy_taps(taps, coef);  // read after the barrier below
  int strip, rb;
  long long row0;
  cta_tile(strips, rows, strip, rb, row0);
  const int col = (strip * kThreads + threadIdx.x) * V;
  const bool live = col < w;  // the others only meet the barrier
  const int nout = (int)min((long long)rows, h - row0);
  const int halo = (ksize - 1) / 2;
  const int nin = nout + ksize - 1;
  const int slots = ksize + kD - 1;
  R* ring = reinterpret_cast<R*>(smem) + threadIdx.x;  // slot s: ring[s * 256]
  // Even row blocks stream down and odd ones up, so two neighbours read
  // the halo rows between them at about the same time: one read from
  // memory, one from L2.  A block of at most kD inputs (NAIVE's one row)
  // streams down: they are all in flight at once.  Input i is the image
  // row of the block's first input plus i gs, and the taps of an output
  // run over its rows top to bottom.
  const bool up = (rb & 1) && nin > kD;
  const int gs = up ? -1 : 1;
  // g: the image row of the next input to issue; off: its element offset
  int g = (int)(up ? row0 + nout - 1 + halo : row0 - halo);
  long long off = (long long)g * w + col;
  const long long step = gs * (long long)w;
  T* dst = out + (up ? row0 + nout - 1 : row0) * w + col;
  Stream<T, V, kD> st;
  auto issue = [&](int d, int slot) {
    const bool ok = (unsigned)g < (unsigned)h;
    st.issue(d, ring + slot * kThreads, x + (ok ? off : 0), ok);
  };
  if constexpr (V == 1 && async_copy<T, V>()) {
    if (nin <= kD) {  // every input in one batch (NAIVE): no turns
      if (live)
        for (int i = 0; i < nin; ++i, ++g, off += w) issue(0, i);
      commit();
      __syncthreads();
      if (!live) return;
      wait_rows<0>();
      for (int r = 0; r < nout; ++r, dst += w) {  // slots r .. r + ksize - 1
        const R* p = ring + r * kThreads;
        float acc = 0.f;
        for (int k = 0; k < ksize; ++k, p += kThreads)
          acc = __fadd_rn(acc, __fmul_rn(coef[k], elem<T, V>(*p, 0)));
        store(dst, acc);
      }
      return;
    }
  }
  for_steps<T, V, kD>(kD, [&](int i, int d) {  // inputs 0 .. kD - 1
    if (live && i < nin) issue(d, i);
    st.done();
    g += gs;
    off += step;
  });
  __syncthreads();
  if (!live) return;  // no barrier follows
  int s = 0;  // the slot of input i
  for_steps<T, V, kD>(nin, [&](int i, int d) {
    st.wait();
    st.land(d, ring + s * kThreads);
    if (i >= ksize - 1) {  // the output whose window ends at input i
      // its top row: input i - (ksize - 1) going down, input i going up
      const int q = up ? s : s - (ksize - 1);
      *reinterpret_cast<R*>(dst) =
          col_output<T, V>(ring, q < 0 ? q + slots : q, gs, slots, coef, ksize);
      dst += step;
    }
    // input i + kD into the slot of input i - ksize + 1, the first row of
    // the output just computed (its reads above come first)
    if (i + kD < nin) {
      const int n = s + kD;
      issue(d, n >= slots ? n - slots : n);
    }
    st.done();
    g += gs;
    off += step;
    s = s + 1 == slots ? 0 : s + 1;
  });
  wait_rows<0>();
}

// Dynamic shared memory of one pass (0 = rows, 1 = columns) at vector
// width V; the 64 taps (256 bytes) are static beside it.
template <typename T, int V>
size_t smem_bytes(int pass, int ksize) {
  const int halo = (ksize - 1) / 2;
  const int hv = (halo + V - 1) / V;
  return pass == 0
             ? sizeof(T) * V * (depth<0, T, V>() + 1) * (kThreads + 2 * hv)
             : sizeof(T) * V * (ksize + depth<1, T, V>() - 1) * kThreads;
}

template <typename T, int V>
void* kernel_of(int pass) {
  return pass == 0 ? (void*)row_pass_kernel<T, V>
                   : (void*)col_pass_kernel<T, V>;
}

template <typename T, int V>
int launch(int pass, const void* x, void* out, int h, int w, int rows,
           int grid, int ksize, const Taps& taps, cudaStream_t stream) {
  const int row_blocks = (h + rows - 1) / rows;
  const int strips = (w + kThreads * V - 1) / (kThreads * V);
  if ((long long)grid != (long long)strips * row_blocks)
    return (int)cudaErrorInvalidValue;
  if (V > 1 && (w % V || (reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out)) % 16))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, V>(pass, ksize);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_of<T, V>(pass), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (pass == 0)
    row_pass_kernel<T, V><<<grid, kThreads, smem, stream>>>(
        xi, o, h, w, rows, strips, ksize, taps);
  else
    col_pass_kernel<T, V><<<grid, kThreads, smem, stream>>>(
        xi, o, h, w, rows, strips, ksize, taps);
  return (int)cudaGetLastError();
}

int run(int pass, const void* x, void* out, int h, int w, int rows, int vec,
        int grid, int ksize, const float* taps, int dtype, void* stream) {
  if (h < 1 || w < 1 || rows < 1 || grid < 1 || ksize < 1 ||
      ksize % 2 == 0 || ksize >= kMaxTaps)
    return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int i = 0; i < ksize; ++i) t.c[i] = taps[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(pass, x, out, h, w, rows, grid, ksize, t, st);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(pass, x, out, h, w, rows, grid, ksize, t, st);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(pass, x, out, h, w, rows, grid, ksize,
                                    t, st);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(pass, x, out, h, w, rows, grid, ksize,
                                    t, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int V>
int occupancy(int pass, int ksize, int* blocks) {
  const size_t smem = smem_bytes<T, V>(pass, ksize);
  void* fn = kernel_of<T, V>(pass);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kThreads, smem);
}

}  // namespace

// One pass over an (h, w) image: grid CTAs of 256 threads, each a block
// of `rows` rows of a strip 256 vec columns wide (vec: 4 f32 or 8 bf16 on
// the vector route, x and out on 16 bytes and w a multiple of vec; 1 on
// the scalar route); grid must be ceil(h / rows) x ceil(w / (256 vec)).
// taps: ksize host floats.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int stencil_rows(const void* x, void* out, int h, int w, int rows,
                            int vec, int grid, int ksize, const float* taps,
                            int dtype, void* stream) {
  return run(0, x, out, h, w, rows, vec, grid, ksize, taps, dtype, stream);
}

extern "C" int stencil_cols(const void* x, void* out, int h, int w, int rows,
                            int vec, int grid, int ksize, const float* taps,
                            int dtype, void* stream) {
  return run(1, x, out, h, w, rows, vec, grid, ksize, taps, dtype, stream);
}

// Resident CTAs per SM that the CUDA runtime reports for one pass (0 =
// rows, 1 = columns) at the route's vector width and ksize (its shared
// memory).
extern "C" int stencil_occupancy(int pass, int vec, int ksize, int dtype,
                                 int* blocks) {
  if ((pass != 0 && pass != 1) || ksize < 1 || ksize >= kMaxTaps)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) return occupancy<float, 4>(pass, ksize, blocks);
  if (dtype == 0 && vec == 1) return occupancy<float, 1>(pass, ksize, blocks);
  if (dtype == 1 && vec == 8)
    return occupancy<__nv_bfloat16, 8>(pass, ksize, blocks);
  if (dtype == 1 && vec == 1)
    return occupancy<__nv_bfloat16, 1>(pass, ksize, blocks);
  return (int)cudaErrorInvalidValue;
}
