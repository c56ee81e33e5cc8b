// Fused binarize -> bitpack -> XNOR-popcount GEMM:
// (M, S) float x  x  (N, ceil(S/32)) packed weights  ->  (M, N).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_bnn.py
// (fused_bnn_matmul -> _fused_bnn_kernel), all four epilogue modes
// (bnn_epilogue.cuh), with z = sum_k popcount(~(xw_k ^ ww_k)) - (Kw*32 - S):
// activation positions at or past S pack to 0 bits, as do the weight's pad
// bits, so each pad position XNORs to 1 and the correction removes it.
//
// Bound on this card: at decode M is the bucketed batch (1..8), so the
// kernel reads the packed weight once, N*Kw*4 bytes (73.7 KB for a
// 768x768 projection, 196.6 KB for 2048x768) — memory, and at that size
// launch latency more than memory.  At prefill (M = 128) it is still
// far below the integer-op roofline.
//
// Design: a block takes BM = 8 activation rows and 8 output columns,
// one column per warp.  The activation tile is binarized and packed in
// shared memory first: a warp reads 32 neighbouring floats
// x[32k + lane] and __ballot_sync puts lane j's bit at bit j (the
// repository's packing order), so packed activations never reach device
// memory.  Then each warp walks its weight row with its lanes on
// neighbouring words (coalesced), keeps one int32 sum per activation
// row, and reduces them across the warp with shuffles.  K is tiled by
// KT words so any S fits the 8 KB of shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bnn_epilogue.cuh"

namespace {

constexpr int BM = 8;       // activation rows per block
constexpr int WARPS = 8;    // output columns per block (one per warp)
constexpr int KT = 256;     // packed words per K tile

__global__ void fused_bnn_kernel(const float* __restrict__ x,
                                 const uint32_t* __restrict__ wp,
                                 const float* __restrict__ alpha,
                                 void* __restrict__ out, int M, int N, int S,
                                 int Kw, float thr, int mode) {
  __shared__ uint32_t xs[BM][KT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const int n = blockIdx.x * WARPS + warp;
  int acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < Kw; k0 += KT) {
    const int kt = min(KT, Kw - k0);
    __syncthreads();                      // previous tile consumed
    for (int idx = warp; idx < rows * kt; idx += WARPS) {   // warp-uniform
      const int r = idx / kt, k = idx % kt;
      const int col = (k0 + k) * 32 + lane;
      const bool bit = col < S && x[(size_t)(m0 + r) * S + col] >= thr;
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) xs[r][k] = word;
    }
    __syncthreads();
    if (n < N) {
      const uint32_t* wrow = wp + (size_t)n * Kw + k0;
      for (int k = lane; k < kt; k += 32) {
        const uint32_t w = wrow[k];
#pragma unroll
        for (int r = 0; r < BM; ++r)
          if (r < rows) acc[r] += __popc(~(xs[r][k] ^ w));
      }
    }
  }
  if (n >= N) return;

#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  if (lane != 0) return;

  const int pad = Kw * 32 - S;
  for (int r = 0; r < rows; ++r)
    bnn_store(out, (size_t)(m0 + r) * N + n, acc[r] - pad, S, alpha, n, mode);
}

}  // namespace

extern "C" int fb_fused_bnn(const void* x, const void* wp, const void* alpha,
                            void* out, int M, int N, int S, int Kw, float thr,
                            int mode, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((N + WARPS - 1) / WARPS, (M + BM - 1) / BM);
  fused_bnn_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)wp, (const float*)alpha, out, M, N, S,
      Kw, thr, mode);
  return (int)cudaGetLastError();
}
