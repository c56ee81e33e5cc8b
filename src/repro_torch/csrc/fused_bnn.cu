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
//    read of the packed weight on CUDA cores.  The packed rows sit in
//    shared memory; each output column is owned by LPC lanes (the power
//    of two that covers its Kw words in 16-, 8- or 4-byte chunks, at
//    most 32); each lane loads its chunks of UNR columns' weight rows
//    with vector loads, the next chunks before using these, adds
//    popc(x ^ w) for every row, and the LPC lanes reduce by shuffles.
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

constexpr int SMALL_M = 8;      // rows the CUDA-core path takes
constexpr int SMALL_WARPS = 8;
constexpr int PACK_THREADS = 256;

// One packed word: bit j = (row[32k + j] >= thr), 0 past S.
__device__ __forceinline__ uint32_t pack_word(const float* __restrict__ row,
                                              int k, int S, float thr,
                                              bool vec4) {
  const int c0 = k * 32;
  uint32_t w = 0;
  if (vec4 && c0 + 32 <= S) {
    const float4* p = reinterpret_cast<const float4*>(row + c0);
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __ldg(p + i);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w |= (uint32_t)(v[i].x >= thr) << (4 * i) |
           (uint32_t)(v[i].y >= thr) << (4 * i + 1) |
           (uint32_t)(v[i].z >= thr) << (4 * i + 2) |
           (uint32_t)(v[i].w >= thr) << (4 * i + 3);
  } else {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = c0 + j < S ? __ldg(row + c0 + j) : thr;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      w |= (uint32_t)(c0 + j < S && v[j] >= thr) << j;
  }
  return w;
}

// VEC packed words as one load (16, 8 or 4 bytes).
template <int VEC> struct Words;
template <> struct Words<4> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const uint32_t* p) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};
template <> struct Words<2> {
  uint32_t w[2];
  __device__ __forceinline__ void load(const uint32_t* p) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  }
};
template <> struct Words<1> {
  uint32_t w[1];
  __device__ __forceinline__ void load(const uint32_t* p) { w[0] = __ldg(p); }
};

// Design b's first launch: x (M, S) -> xp (M, KwP), one thread per word.
__global__ void pack_rows_kernel(const float* __restrict__ x,
                                 uint32_t* __restrict__ xp, int M, int S,
                                 int Kw, int KwP, float thr, bool vec4) {
  const int idx = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (idx >= M * KwP) return;
  const int m = idx / KwP, k = idx % KwP;
  xp[idx] = k < Kw ? pack_word(x + (size_t)m * S, k, S, thr, vec4) : 0u;
}

// M <= 8: packed rows in shared memory, the weight read once.  Each lane
// group loads UNR columns' chunks before using any, and the next chunks
// before using these, so a lane keeps UNR to 2 UNR vector loads in
// flight; the first loads are issued before the activations are packed,
// so the two do not wait on each other.
template <int VEC, int UNR>
__device__ __forceinline__ void load_cols(Words<VEC> (&w)[UNR],
                                          const uint32_t* __restrict__ wp,
                                          int n0, int cpw, int N, int Kw,
                                          int k) {
#pragma unroll
  for (int u = 0; u < UNR; ++u) {
    const int n = n0 + u * cpw;
    if (n < N && k < Kw) w[u].load(wp + (size_t)n * Kw + k);
  }
}

template <int VEC, bool PREPACKED, int UNR>
__global__ __launch_bounds__(SMALL_WARPS * 32) void fused_bnn_small_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ xp,
    const uint32_t* __restrict__ wp, const float* __restrict__ alpha,
    void* __restrict__ out, int M, int N, int S, int Kw, int KwP,
    int lpc_log2, float thr, int mode, bool vec4) {
  extern __shared__ __align__(16) uint32_t xs[];          // [M][KwP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpc = 1 << lpc_log2, sub = lane & (lpc - 1);
  const int cpw = 32 >> lpc_log2;                 // columns per warp pass
  const int n0 = (blockIdx.x * SMALL_WARPS + warp) * cpw * UNR +
                 (lane >> lpc_log2);
  const int step = lpc * VEC;
  Words<VEC> w[UNR];
  load_cols(w, wp, n0, cpw, N, Kw, sub * VEC);
  for (int e = threadIdx.x; e < M * KwP; e += blockDim.x) {
    const int m = e / KwP, k = e % KwP;
    xs[e] = PREPACKED ? xp[e]
                      : (k < Kw ? pack_word(x + (size_t)m * S, k, S, thr, vec4)
                                : 0u);
  }
  __syncthreads();
  int mis[UNR][SMALL_M];
#pragma unroll
  for (int u = 0; u < UNR; ++u)
#pragma unroll
    for (int r = 0; r < SMALL_M; ++r) mis[u][r] = 0;
  for (int k = sub * VEC; k < Kw; k += step) {
    Words<VEC> cur[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) cur[u] = w[u];
    load_cols(w, wp, n0, cpw, N, Kw, k + step);
#pragma unroll
    for (int r = 0; r < SMALL_M; ++r) {
      if (r >= M) break;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const uint32_t a = xs[r * KwP + k + v];
#pragma unroll
        for (int u = 0; u < UNR; ++u) mis[u][r] += __popc(a ^ cur[u].w[v]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNR; ++u) {
#pragma unroll
    for (int r = 0; r < SMALL_M; ++r) {
      if (r >= M) break;                          // block-uniform
      for (int off = lpc >> 1; off > 0; off >>= 1)
        mis[u][r] += __shfl_xor_sync(0xffffffffu, mis[u][r], off);
    }
    const int n = n0 + u * cpw;
    if (n < N && sub == 0)
#pragma unroll
      for (int r = 0; r < SMALL_M; ++r)
        if (r < M)
          bnn_store(out, (size_t)r * N + n, S - mis[u][r], S, alpha, n, mode);
  }
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

// SMs of the current device, read once per device.
cudaError_t sm_count(int* sms) {
  static int count[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count[dev];
  return cudaSuccess;
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

// The CUDA-core path's launch shape: lpc lanes per column (log2), UNR
// columns per lane group, blocks.
struct SmallShape {
  int lg, unr, blocks;
};
template <int VEC>
SmallShape small_shape(int N, int Kw, int sms) {
  const int chunks = Kw / VEC;
  int lg = 0;
  while ((1 << lg) < chunks && lg < 5) ++lg;
  const int cols = SMALL_WARPS * (32 >> lg);      // per block, UNR = 1
  const int blocks1 = (N + cols - 1) / cols;
  // a grid of several waves gives each lane 4 columns' loads in flight
  const int unr = blocks1 >= 4 * sms ? 4 : 1;
  return {lg, unr, (N + cols * unr - 1) / (cols * unr)};
}

template <int VEC, bool PRE>
cudaError_t launch_small(const Args& a, const SmallShape& sh) {
  const size_t smem = sizeof(uint32_t) * a.M * a.KwP;
  const auto k = sh.unr == 4 ? fused_bnn_small_kernel<VEC, PRE, 4>
                             : fused_bnn_small_kernel<VEC, PRE, 1>;
  k<<<sh.blocks, SMALL_WARPS * 32, smem, a.stream>>>(
      a.x, a.xp, a.wp, a.alpha, a.out, a.M, a.N, a.S, a.Kw, a.KwP, sh.lg,
      a.thr, a.mode, a.vec4);
  return cudaGetLastError();
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
    const SmallShape sh = small_shape<VEC>(a.N, a.Kw, sms);
    // a single wave packs in its blocks and saves the pack launch
    if (sh.blocks <= sms) return launch_small<VEC, false>(a, sh);
    const cudaError_t err = pack_rows(a);
    return err != cudaSuccess ? err : launch_small<VEC, true>(a, sh);
  }
  const cudaError_t err = pack_rows(a);
  if (err != cudaSuccess) return err;
  return bnn_gemm::launch_tc<VEC>(a.xp, a.wp, a.alpha, a.out, a.M, a.N, a.S,
                                  a.Kw, a.KwP, a.mode, sms, a.stream);
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
  const uintptr_t wa = (uintptr_t)wp;
  const int vec = Kw % 4 == 0 && wa % 16 == 0 ? 4
                  : Kw % 2 == 0 && wa % 8 == 0 ? 2 : 1;
  const Args a{(const float*)x, (uint32_t*)xp, (const uint32_t*)wp,
               (const float*)alpha, out, M, N, S, Kw, (Kw + 3) & ~3, thr,
               mode, S % 4 == 0 && (uintptr_t)x % 16 == 0,
               (cudaStream_t)stream};
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
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
