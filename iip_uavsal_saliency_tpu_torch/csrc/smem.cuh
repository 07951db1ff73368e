// Host-side helper shared by the kernel sources (each built into a library
// of its own, so each gets its own copy).

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device. The attribute is set only when a launch needs more than any before
// it on that device (it is never lowered), so that launches after the first,
// among them those captured into a CUDA graph (serving/steps.py::graph_step,
// whose warm-up makes the first), make no host call but the launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> allowed;  // (kernel, device) -> set
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel), device);
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= allowed[key]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed[key] = smem;
  return err;
}

}  // namespace
