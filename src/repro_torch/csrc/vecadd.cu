// vecadd, out = x + y over a 1-D vector, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vecadd.py::_vecadd_kernel (the Pallas
// kernel that vecadd_pallas launches at :43), the paper's Fig. 1 kernel.
//
// Bound on the H100: bytes, 3 n * sizeof(T) / 3.35 TB/s.  Design:
// csrc/vector_map.cuh's map (16-byte vectors, four loads a batch before
// the adds, where lws >= v and the pointers lie on 16 bytes; scalars
// otherwise).  Inputs fp32 or bf16; the add is done in fp32 with
// __fadd_rn and rounded once, which for two bf16 operands is the
// correctly rounded bf16 sum: both widths give the plain version's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vector_map.cuh"

namespace {

struct Add {
  __device__ __forceinline__ float operator()(float x, float y) const {
    return __fadd_rn(x, y);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  steps > 0: the vector kernel, steps
// 16-byte vectors a thread (x, y and out on 16 bytes); 0: the scalar
// kernel, lws elements a thread.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int vecadd(const void* x, const void* y, void* out, long long n,
                      int lws, int grid, int steps, int dtype,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector_map::launch<float>(Add{}, x, y, out, n, lws, grid, steps,
                                     st);
  if (dtype == 1)
    return vector_map::launch<__nv_bfloat16>(Add{}, x, y, out, n, lws, grid,
                                             steps, st);
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM that the CUDA runtime reports for the vector
// (vector != 0) or the scalar kernel.
extern "C" int vecadd_occupancy(int dtype, int vector, int* blocks) {
  if (dtype == 0) return vector_map::occupancy<float, Add>(vector, blocks);
  if (dtype == 1)
    return vector_map::occupancy<__nv_bfloat16, Add>(vector, blocks);
  return (int)cudaErrorInvalidValue;
}
