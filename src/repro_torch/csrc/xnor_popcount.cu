// Packed XNOR-popcount GEMM:
// (M, Kw) packed inputs  x  (N, Kw) packed weights  ->  (M, N).
//
// Replaces the Pallas TPU kernel src/repro/kernels/xnor_popcount.py
// (xnor_popcount_matmul -> _xnor_popcount_kernel), all four epilogue
// modes (bnn_epilogue.cuh), with
//   z = sum_k popcount(~(ip[m,k] ^ wp[n,k])) - (Kw*32 - S)
//     = S - sum_k popcount(ip[m,k] ^ wp[n,k]).
// Both operands were packed with -1.0 padding, so their pad bits are 0
// and agree; Kw is the word count the wrapper passes (at least
// ceil(S/32)).
//
// Where it runs: core/conv.bnn_conv2d lowers a binarized conv to one such
// GEMM (im2col patches x flattened HWIO weights).  At the four BNNs'
// published layer shapes (batch 1) M is 1..12544 output pixels, N is
// 10..1280 output channels and Kw is 1..256 words.
//
// Bound on this card: by bytes for nearly all of those layers — the
// int32 output (M*N*4) and the packed operands against 2*M*N*S binary
// operations at the binary mma's rate (chip_smoke.py measures it).  Most
// layers are a few microseconds, so the goal is a short critical path
// and a grid that fills the card.
//
// Design: three routes, chosen in Python (kernels/xnor_popcount.py,
// xnor_plan) and passed in as ints:
//  * ROUTE_READ (M <= 8: the fully connected layers): bnn_gemm.cuh's
//    small_kernel, a read of the packed weight on CUDA cores, its rows
//    staged from ip.
//  * ROUTE_TILE (K shorter than one 8-word binary mma step: the first
//    layers and the 1x1 layers of few channels): tile_kernel below,
//    CUDA-core popcounts on 64 x 64 tiles, 4 x 4 outputs a thread.
//    There one mma step would be mostly zero words, and its fixed costs
//    (the async stage, the popcount shuffles) lose to this tile.
//  * ROUTE_MMA: bnn_gemm.cuh's tc_kernel, binary mma tiles of 64 x bn;
//    K split over `parts` blocks of kpart words (bn = 32) where the tile
//    grid would leave SMs idle, the last block of each tile reducing the
//    parts (one launch; `part` is a (parts, tiles, 64 x 32) int32
//    scratch and `counters` one int per tile, 0 between launches).
// Copies are 4, 2 or 1 words wide, the widest that Kw and the operands'
// alignment allow: an ip view may start at any word.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bnn_epilogue.cuh"
#include "bnn_gemm.cuh"

namespace {

constexpr int ROUTE_READ = 0, ROUTE_TILE = 1, ROUTE_MMA = 2;

// ROUTE_TILE: the port's first XNOR GEMM kernel, kept for K under one
// binary mma step, where it is as fast as the mma tiles or faster.
// A block of 256 threads owns a BM x BN = 64 x 64 output tile and walks
// K in tiles of KT = 32 words, staging the ip and wp words of each tile
// in shared memory, k-major (column r of tile k at [k][r], rows padded
// to 65 words so the transposing store hits 32 distinct banks).  The
// staging loads read the tile's rows as one flat run of words, so a row
// of a narrow operand costs no wasted lanes.  Each thread keeps a 4 x 4
// register tile of sums of popcount(~(a ^ w)) over all Kw words (rows
// ty + 16i, columns tx + 16j, so neighbouring threads read neighbouring
// shared-memory columns and write neighbouring output columns), less
// the Kw * 32 - S pad positions, which agree.
constexpr int BM = 64;         // output rows per block
constexpr int BN = 64;         // output columns per block
constexpr int KT = 32;         // packed words per K tile
constexpr int TTHREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = BM / 16;
constexpr int TN = BN / 16;
constexpr int TMAXK = 7;       // the route's deepest K, in words

__global__ void __launch_bounds__(TTHREADS)
tile_kernel(const uint32_t* __restrict__ ip, const uint32_t* __restrict__ wp,
            const float* __restrict__ alpha, void* __restrict__ out, int M,
            int N, int S, int Kw, int mode) {
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
    for (int idx = threadIdx.x; idx < BM * kt; idx += TTHREADS) {
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

template <int VEC>
cudaError_t launch(const uint32_t* ip, const uint32_t* wp, const float* alpha,
                   void* out, int* part, int* counters, int M, int N, int S,
                   int Kw, int route, int bn, int parts, int kpart, int mode,
                   int sms, cudaStream_t st) {
  if (route == ROUTE_READ) {
    const bnn_gemm::SmallShape sh = bnn_gemm::small_shape(VEC, N, Kw, sms);
    return bnn_gemm::launch_small<VEC, true>(nullptr, ip, wp, alpha, out, M,
                                             N, S, Kw, Kw, 0.f, mode,
                                             false, sh, st);
  }
  if (route == ROUTE_TILE) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    tile_kernel<<<grid, TTHREADS, 0, st>>>(ip, wp, alpha, out, M, N, S, Kw,
                                           mode);
    return cudaGetLastError();
  }
  return bnn_gemm::launch_tc<VEC>(ip, wp, alpha, out, part, counters, M, N,
                                  S, Kw, Kw, bn, parts, kpart, mode, st);
}

}  // namespace

extern "C" int xp_xnor_popcount(const void* ip, const void* wp,
                                const void* alpha, void* out, void* part,
                                void* counters, int M, int N, int S, int Kw,
                                int route, int bn, int parts, int kpart,
                                int mode, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  // the plan: the weight read at M <= 8 only, the tile under TMAXK
  // words; split parts of a multiple of 8 words, none of them empty,
  // with their scratch
  const bool ok =
      route == ROUTE_READ ? M <= bnn_gemm::SMALL_M &&
                                (size_t)M * Kw * 4 <= 48 * 1024
      : route == ROUTE_TILE ? Kw <= TMAXK
      : route == ROUTE_MMA &&
          (bn == 32 || bn == 64) && parts >= 1 && kpart > 0 &&
          (long long)(parts - 1) * kpart < Kw &&
          (long long)parts * kpart >= Kw &&
          (parts == 1 || (bn == 32 && kpart % 8 == 0 && part != nullptr &&
                          counters != nullptr));
  if (!ok) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = bnn_gemm::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const auto* a = (const uint32_t*)ip;
  const auto* w = (const uint32_t*)wp;
  const int vec = bnn_gemm::vec_words(Kw, Kw, ip, wp);
  const auto fn = vec == 4 ? launch<4> : vec == 2 ? launch<2> : launch<1>;
  return (int)fn(a, w, (const float*)alpha, out, (int*)part, (int*)counters,
                 M, N, S, Kw, route, bn, parts, kpart, mode, sms,
                 (cudaStream_t)stream);
}
