// Fused binarize -> bitpack -> XNOR-popcount GEMM:
// (M, S) float x  x  (N, ceil(S/32)) packed weights  ->  (M, N).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_bnn.py
// (fused_bnn_matmul -> _fused_bnn_kernel), all four epilogue modes
// (bnn_epilogue.cuh).  Activation positions at or past S pack to 0
// bits, as do the weight's pad bits, so every pad position agrees and
// the bitcount is z = S - mismatches, the kernel's pad correction.
//
// Bound on this card.  At decode (M <= 8) the kernel is a read of the
// packed weight, N * Kw * 4 bytes: 73.7 KB for a 768 x 768 projection,
// 7.3 MB for a mixtral expert's 14336 x 4096 (2.2 us at 3.35 TB/s).  At
// prefill (M = 128, N = 2048, S = 768) the bytes are 0.6 MB and the
// 2 M N S = 0.40 G operations take 0.2 us at the int8 tensor-core rate
// (less at the binary mma's, which chip_smoke.py measures on the card);
// both are far below launch latency, so the goal there is a short
// critical path, not the roofline.  At mixtral's prefill widths (M = 32
// rows of an expert, N = 14336, S = 4096) it is the weight's 7.3 MB
// again: 2.9 us.
//
// Design.  The activations are binarized and packed ONCE per GEMM
// (design b): a first launch packs x into an (M, KwP) int32 scratch the
// wrapper allocates (one thread per word, eight 16-byte loads in
// flight; KwP is Kw rounded up to 4 words, zero-filled, so every packed
// row is 16-byte aligned).  Where the decode path's grid is a single
// wave, its blocks pack the rows themselves instead (design a): the
// re-reads are few and a launch is saved.  Then, chosen by M:
//  * M <= 8 (decode, and mixtral's experts at decode; S <= 49152): a
//    read of the packed weight on CUDA cores (bnn_gemm.cuh,
//    small_kernel).
//  * M > 8: the packed x packed core of bnn_gemm.cuh on tensor cores
//    (binary mma.m16n8k256 with AND + popcount).  Binary mma beat int8
//    mma.m16n8k32 on +-1 bytes expanded from the words at every shape
//    the smoke times (the int8 product was 1.06-3.1x slower, bound by
//    the integer ALUs' expansion), so it is the one product.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bnn_epilogue.cuh"
#include "bnn_gemm.cuh"

namespace {

using bnn_gemm::SMALL_M;
constexpr int PACK_THREADS = 256;

// Design b's first launch: x (M, S) -> xp (M, KwP), one thread per word.
__global__ void pack_rows_kernel(const float* __restrict__ x,
                                 uint32_t* __restrict__ xp, int M, int S,
                                 int Kw, int KwP, float thr, bool vec4) {
  const int idx = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (idx >= M * KwP) return;
  const int m = idx / KwP, k = idx % KwP;
  xp[idx] = k < Kw ? bnn_gemm::pack_word(x + (size_t)m * S, k, S, thr, vec4)
                   : 0u;
}

// The binary mma's peak rate, which no data sheet gives for this card:
// every warp runs `iters` rounds of 8 independent mma.m16n8k256.b1 on
// registers; the caller times the launch.
__global__ __launch_bounds__(256) void b1_mma_rate_kernel(int* out,
                                                          int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, ~threadIdx.x,
                         threadIdx.x ^ 0x5555u};
  int acc[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bnn_gemm::mma_b1_and(acc[j], a, a[j & 3], a[(j + 1) & 3]);
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

struct Args {
  const float* x;
  uint32_t* xp;
  const uint32_t* wp;
  const float* alpha;
  void* out;
  int M, N, S, Kw, KwP;
  float thr;
  int mode;
  bool vec4;
  cudaStream_t stream;
};

template <int VEC, bool PRE>
cudaError_t launch_small(const Args& a, const bnn_gemm::SmallShape& sh) {
  return bnn_gemm::launch_small<VEC, PRE>(
      a.x, a.xp, a.wp, a.alpha, a.out, a.M, a.N, a.S, a.Kw, a.KwP,
      a.thr, a.mode, a.vec4, sh, a.stream);
}

cudaError_t pack_rows(const Args& a) {
  const int words = a.M * a.KwP;
  pack_rows_kernel<<<(words + PACK_THREADS - 1) / PACK_THREADS, PACK_THREADS,
                     0, a.stream>>>(a.x, a.xp, a.M, a.S, a.Kw, a.KwP, a.thr,
                                    a.vec4);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch(const Args& a, int sms) {
  if (a.M <= SMALL_M && (size_t)a.M * a.KwP * 4 <= 48 * 1024) {
    const bnn_gemm::SmallShape sh = bnn_gemm::small_shape(VEC, a.N, a.Kw, sms);
    // a single wave packs in its blocks and saves the pack launch
    if (sh.blocks <= sms) return launch_small<VEC, false>(a, sh);
    const cudaError_t err = pack_rows(a);
    return err != cudaSuccess ? err : launch_small<VEC, true>(a, sh);
  }
  const cudaError_t err = pack_rows(a);
  if (err != cudaSuccess) return err;
  // 32-column tiles where 64-column ones would give fewer blocks than
  // the card has SMs
  const int mt = (a.M + bnn_gemm::TBM - 1) / bnn_gemm::TBM;
  const int bn = mt * ((a.N + 63) / 64) < sms ? 32 : 64;
  return bnn_gemm::launch_tc<VEC>(a.xp, a.wp, a.alpha, a.out, nullptr,
                                  nullptr, a.M, a.N, a.S, a.Kw, a.KwP, bn, 1,
                                  a.Kw, a.mode, a.stream);
}

}  // namespace

// xp: an (M, KwP) int32 scratch, 16-byte aligned, KwP = Kw rounded up
// to 4: the packed activations (design b).  The decode path leaves it
// unused where its grid is a single wave.
extern "C" int fb_fused_bnn(const void* x, const void* wp, const void* alpha,
                            void* out, void* xp, int M, int N, int S, int Kw,
                            float thr, int mode, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (xp == nullptr || (uintptr_t)xp % 16) return (int)cudaErrorInvalidValue;
  const int KwP = (Kw + 3) & ~3;
  const int vec = bnn_gemm::vec_words(Kw, KwP, wp, xp);
  const Args a{(const float*)x, (uint32_t*)xp, (const uint32_t*)wp,
               (const float*)alpha, out, M, N, S, Kw, KwP, thr,
               mode, S % 4 == 0 && (uintptr_t)x % 16 == 0,
               (cudaStream_t)stream};
  int sms = 0;
  const cudaError_t err = bnn_gemm::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (vec == 4) return (int)launch<4>(a, sms);
  if (vec == 2) return (int)launch<2>(a, sms);
  return (int)launch<1>(a, sms);
}

// The rate probe: `blocks` x 256 threads of the binary mma loop above
// on `stream`, one int per thread to `out`; each warp does 8 * iters
// mma.m16n8k256, 2 * 16 * 8 * 256 operations each.  The caller times it.
extern "C" int fb_b1_mma_rate(void* out, int blocks, int iters,
                              void* stream) {
  b1_mma_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((int*)out,
                                                               iters);
  return (int)cudaGetLastError();
}
