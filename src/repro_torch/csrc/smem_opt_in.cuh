// Dynamic shared memory above 48 KB needs an opt-in per kernel, and
// cudaFuncSetAttribute acts on the CURRENT device only: a second card in
// the same process needs its own.  Each launcher keeps one `granted`
// array per kernel (a function-local static), indexed by device; the
// opt-in is made once per device and size.  The Python launcher
// (kernels/_lib.launch) makes the tensors' device current around every
// call.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

namespace dyn_smem {

constexpr int MAX_DEVICES = 64;

template <typename Kernel>
inline cudaError_t opt_in(Kernel kernel, size_t bytes,
                          size_t (&granted)[MAX_DEVICES]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes > granted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    granted[dev] = bytes;
  }
  return cudaSuccess;
}

}  // namespace dyn_smem
