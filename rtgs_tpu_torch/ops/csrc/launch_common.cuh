// Host-side launch helpers shared by every source here: what a C entry
// point does before its <<<...>>>, kept off the per-call path where the
// answer cannot have changed.

#pragma once

#include <atomic>
#include <cuda_runtime.h>

namespace {

// Make `device` the calling thread's current device, asking the runtime to
// switch only when another one is.
inline cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// Let kKernel take `bytes` of dynamic shared memory (above the 48 KB a
// kernel gets unasked). The attribute belongs to the kernel and the device:
// the largest size granted to each pair is remembered, and the runtime is
// asked only for more (devices from 64 on are asked every time).
template <auto kKernel>
cudaError_t dynamic_smem_opt_in(int device, int bytes) {
  constexpr int kDevices = 64;
  static std::atomic<int> granted[kDevices];
  const bool known = device >= 0 && device < kDevices;
  if (known && bytes <= granted[device].load(std::memory_order_relaxed))
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known)
    granted[device].store(bytes, std::memory_order_relaxed);
  return err;
}

}  // namespace
