// A kernel's dynamic shared-memory limit raised past the 48 KB a launch
// takes without it, once per kernel and device instead of on every
// launch (csrc/matmul_tc.cu, csrc/matmul_tf32x3.cu, csrc/rmsnorm.cu).

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace smem_optin {

// Raises fn's limit to the current device's opt-in maximum, unless
// `devices` (one per kernel, a bit per device) says it was raised there
// already.  The limit is a ceiling only: the shared memory a launch asks
// for, and so its occupancy, is unchanged.
inline cudaError_t allow(const void* fn, std::atomic<unsigned>& devices) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit & devices.load(std::memory_order_acquire)) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess) devices.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace smem_optin
