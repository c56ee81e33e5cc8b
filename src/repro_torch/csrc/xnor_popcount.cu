// Packed XNOR-popcount GEMM:
// (M, Kw) packed inputs  x  (N, Kw) packed weights  ->  (M, N).
//
// Replaces the Pallas TPU kernel src/repro/kernels/xnor_popcount.py
// (xnor_popcount_matmul -> _xnor_popcount_kernel), all four epilogue
// modes (bnn_epilogue.cuh), with
//   z = sum_k popcount(~(ip[m,k] ^ wp[n,k])) - (Kw*32 - S).
// Both operands were packed with -1.0 padding, so their pad bits are 0;
// each pad position XNORs to 1 and the correction removes it.  Kw is the
// word count the wrapper passes (at least ceil(S/32)).
//
// Where it runs: core/conv.bnn_conv2d lowers a binarized conv to one such
// GEMM (im2col patches x flattened HWIO weights).  At the four BNNs'
// published layer shapes (batch 1) M is 1..12544 output pixels, N is
// 10..1280 output channels and Kw is 1..256 words.
//
// Bound on this card: by bytes for most of those layers — the int32
// output (M*N*4) outweighs the packed operands, and the XNOR-popcount
// work (2*M*N*S binary ops) is small beside the int8 tensor-core rate
// the bound is taken against.  Most layers are a few microseconds of
// memory traffic, so launch latency dominates.
//
// Design: a simple tiled kernel.  A block of 256 threads owns a
// BM x BN = 64 x 64 output tile and walks K in tiles of KT = 32 words,
// staging the ip and wp words of each tile in shared memory, k-major
// (column r of tile k at [k][r], rows padded to 65 words so the
// transposing store hits 32 distinct banks).  The staging loads read the
// tile's rows as one flat run of words, so a row of a narrow operand
// (Kw < 32) costs no wasted lanes.  Each thread keeps a 4 x 4 register
// tile of int32 sums: rows ty + 16i, columns tx + 16j, so neighbouring
// threads read neighbouring shared-memory columns and write neighbouring
// output columns.  Every edge (M, N, Kw) is guarded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bnn_epilogue.cuh"

namespace {

constexpr int BM = 64;         // output rows per block
constexpr int BN = 64;         // output columns per block
constexpr int KT = 32;         // packed words per K tile
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = BM / 16;
constexpr int TN = BN / 16;

__global__ void __launch_bounds__(THREADS)
xnor_popcount_kernel(const uint32_t* __restrict__ ip,
                     const uint32_t* __restrict__ wp,
                     const float* __restrict__ alpha,
                     void* __restrict__ out, int M, int N, int S, int Kw,
                     int mode) {
  __shared__ uint32_t as[KT][BM + 1];
  __shared__ uint32_t bs[KT][BN + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < Kw; k0 += KT) {
    const int kt = min(KT, Kw - k0);
    for (int idx = threadIdx.x; idx < BM * kt; idx += THREADS) {
      const int r = idx / kt, c = idx - r * kt;
      const int m = m0 + r, n = n0 + r;
      as[c][r] = m < M ? ip[(size_t)m * Kw + k0 + c] : 0u;
      bs[c][r] = n < N ? wp[(size_t)n * Kw + k0 + c] : 0u;
    }
    __syncthreads();
    for (int c = 0; c < kt; ++c) {
      uint32_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += __popc(~(a[i] ^ b[j]));
    }
    __syncthreads();                      // tile consumed before the next
  }

  const int pad = Kw * 32 - S;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        bnn_store(out, (size_t)m * N + n, acc[i][j] - pad, S, alpha, n, mode);
    }
  }
}

}  // namespace

extern "C" int xp_xnor_popcount(const void* ip, const void* wp,
                                const void* alpha, void* out, int M, int N,
                                int S, int Kw, int mode, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  xnor_popcount_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ip, (const uint32_t*)wp, (const float*)alpha, out, M, N,
      S, Kw, mode);
  return (int)cudaGetLastError();
}
