// The packed BNN GEMMs' shared epilogue (fused_bnn.cu, xnor_popcount.cu):
// turns one pad-corrected bitcount z of an S-bit contraction into the
// mode's output element, as kernels/ref.py::epilogue does:
//   0 bitcount    z                       int32
//   1 dot         2z - S                  int32
//   2 dot_scaled  (2z - S) * alpha[n]     float32 (alpha is read only here)
//   3 binary_act  z > S/2                 uint8
#pragma once
#include <stddef.h>
#include <stdint.h>

__device__ __forceinline__ void bnn_store(void* __restrict__ out, size_t o,
                                          int z, int S,
                                          const float* __restrict__ alpha,
                                          int n, int mode) {
  switch (mode) {
    case 0: ((int32_t*)out)[o] = z; break;
    case 1: ((int32_t*)out)[o] = 2 * z - S; break;
    case 2: ((float*)out)[o] = (float)(2 * z - S) * alpha[n]; break;
    default: ((uint8_t*)out)[o] = (uint8_t)(2 * z > S); break;
  }
}
