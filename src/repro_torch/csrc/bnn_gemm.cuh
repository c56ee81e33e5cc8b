// The packed BNN GEMM cores shared by fused_bnn.cu and xnor_popcount.cu:
// (M, lda) packed activations  x  (N, Kw) packed weights  ->  (M, N),
// z = S - popcount(a ^ w) per element over the first Kw words, stored
// through bnn_epilogue.cuh.  Bits past S are 0 on both sides (the packs
// write them so, and the words past Kw are never read), so they count
// nowhere.  Two routes, chosen by the caller:
//
//  * M <= SMALL_M (decode, and the conv path's fully connected layers):
//    small_kernel, a read of the packed weight on CUDA cores.  The
//    packed rows sit in shared memory; each output column is owned by
//    LPC lanes (the power of two that covers its Kw words in 16-, 8- or
//    4-byte chunks, at most 32); each lane loads its chunks of UNR
//    columns' weight rows with vector loads, the next chunks before
//    using these, adds popc(x ^ w) for every row, and the LPC lanes
//    reduce by shuffles.  The rows come packed (PREPACKED) or are
//    binarized and packed by the blocks themselves (pack_word).
//  * M > SMALL_M: tc_kernel on tensor cores.  A block owns a 64 x BN
//    output tile (BN = 64, or 32 where 64-wide tiles would not fill the
//    card), four warps of 32 x BN/2; K runs in tiles of 32 words (1024
//    bits) staged with cp.async, double-buffered, VEC words a copy for
//    both operands (VEC divides Kw and lda, and both pointers are
//    VEC * 4-byte aligned).  The product is mma.m16n8k256.b1 with AND +
//    popcount on the packed words as they are, 8 words per step: the
//    row and column popcounts, summed as the fragments load, turn the
//    both-one count c into mismatches pa + pb - 2c.  Split K (SPLIT,
//    BN = 32): where the tile grid leaves SMs idle, the caller launches
//    `parts` blocks per tile (gridDim.z), each over kpart words.
//    Mismatch counts add across parts: each part writes its tile of
//    counts to an int32 scratch, then bumps the tile's counter with
//    release semantics; the last part to arrive (acquire) adds the
//    others' tiles to its own, leaves the counter at 0 for the next
//    launch, and alone runs the epilogue, so binary_act and dot_scaled
//    never see a partial sum.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bnn_epilogue.cuh"

namespace bnn_gemm {

constexpr int TBM = 64, TKW = 32;   // tile rows; K tile in words
constexpr int LDW = TKW + 4;        // smem row stride: 16-byte rows, and rows
                                    // g = 0..7 of a fragment on distinct banks
constexpr int THREADS = 128;
constexpr int SMALL_M = 8;          // rows the CUDA-core route takes
constexpr int SMALL_WARPS = 8;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += popc(a AND b) over one m16n8k256 fragment of packed bits.
__device__ __forceinline__ void mma_b1_and(int (&c)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// The widest copy (4, 2 or 1 words) that divides every row length in
// words and the alignment of every pointer given.
inline int vec_words(int kw, int lda, const void* a, const void* b) {
  const uintptr_t al = (uintptr_t)a | (uintptr_t)b;
  if (kw % 4 == 0 && lda % 4 == 0 && al % 16 == 0) return 4;
  if (kw % 2 == 0 && lda % 2 == 0 && al % 8 == 0) return 2;
  return 1;
}

// SMs of the current device, read once per device.
inline cudaError_t sm_count(int* sms) {
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

// ------------------------------------------------------- M <= SMALL_M

// Each lane group loads UNR columns' chunks before using any, and the
// next chunks before using these, so a lane keeps UNR to 2 UNR vector
// loads in flight; the first loads are issued before the activations
// are staged, so the two do not wait on each other.
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

// x (M, S) floats (packed here) or xp (M, lda) packed words
// (PREPACKED, lda >= Kw, words past Kw zero); the rows sit in shared
// memory at the same stride of lda words.
template <int VEC, bool PREPACKED, int UNR>
__global__ __launch_bounds__(SMALL_WARPS * 32) void small_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ xp,
    const uint32_t* __restrict__ wp, const float* __restrict__ alpha,
    void* __restrict__ out, int M, int N, int S, int Kw, int lda,
    int lpc_log2, float thr, int mode, bool vec4) {
  extern __shared__ __align__(16) uint32_t xs[];          // [M][lda]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpc = 1 << lpc_log2, sub = lane & (lpc - 1);
  const int cpw = 32 >> lpc_log2;                 // columns per warp pass
  const int n0 = (blockIdx.x * SMALL_WARPS + warp) * cpw * UNR +
                 (lane >> lpc_log2);
  const int step = lpc * VEC;
  Words<VEC> w[UNR];
  load_cols(w, wp, n0, cpw, N, Kw, sub * VEC);
  for (int e = threadIdx.x; e < M * lda; e += blockDim.x) {
    const int m = e / lda, k = e % lda;
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
        const uint32_t a = xs[r * lda + k + v];
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

// The CUDA-core route's launch shape: lpc lanes per column (log2), UNR
// columns per lane group, blocks.
struct SmallShape {
  int lg, unr, blocks;
};
inline SmallShape small_shape(int vec, int N, int Kw, int sms) {
  const int chunks = Kw / vec;
  int lg = 0;
  while ((1 << lg) < chunks && lg < 5) ++lg;
  const int cols = SMALL_WARPS * (32 >> lg);      // per block, UNR = 1
  const int blocks1 = (N + cols - 1) / cols;
  // a grid of several waves gives each lane 4 columns' loads in flight
  const int unr = blocks1 >= 4 * sms ? 4 : 1;
  return {lg, unr, (N + cols * unr - 1) / (cols * unr)};
}

template <int VEC, bool PRE>
inline cudaError_t launch_small(const float* x, const uint32_t* xp,
                                const uint32_t* wp, const float* alpha,
                                void* out, int M, int N, int S, int Kw,
                                int lda, float thr, int mode, bool vec4,
                                const SmallShape& sh, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * M * lda;
  const auto k = sh.unr == 4 ? small_kernel<VEC, PRE, 4>
                             : small_kernel<VEC, PRE, 1>;
  k<<<sh.blocks, SMALL_WARPS * 32, smem, stream>>>(
      x, xp, wp, alpha, out, M, N, S, Kw, lda, sh.lg, thr, mode, vec4);
  return cudaGetLastError();
}

// -------------------------------------------------------- M > SMALL_M

// SPLIT: part holds (gridDim.z, tiles, TBM x BN) ints of scratch and
// counters one int per tile (blockIdx.y * gridDim.x + blockIdx.x), 0
// between launches.
template <int VEC, int BN, bool SPLIT>
__global__ __launch_bounds__(THREADS) void tc_kernel(
    const uint32_t* __restrict__ xp, const uint32_t* __restrict__ wp,
    const float* __restrict__ alpha, void* __restrict__ out,
    int* __restrict__ part, int* __restrict__ counters, int M, int N, int S,
    int Kw, int lda, int kpart, int mode) {
  constexpr int NI = BN / 16;                     // n fragments per warp
  __shared__ __align__(16) uint32_t As[2][TBM][LDW];
  __shared__ __align__(16) uint32_t Bs[2][BN][LDW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BN / 2);
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * BN;
  // this part's words [kb, ke); kpart is a multiple of 8 words
  const int kb = SPLIT ? blockIdx.z * kpart : 0;
  const int ke = SPLIT ? min(Kw, kb + kpart) : Kw;
  const int nk = (ke - kb + TKW - 1) / TKW;

  // every stage is copied full width: words past the part's end are
  // cp.async's zero fill
  auto load_tile = [&](int st, int kt) {
    const int k0 = kb + kt * TKW;
    constexpr int CPR = TKW / VEC;                 // chunks per row
    for (int c = tid; c < BN * CPR; c += THREADS) {
      const int r = c / CPR, kk = (c % CPR) * VEC, n = n0 + r, k = k0 + kk;
      const bool ok = n < N && k < ke;
      cp_async<VEC * 4>(&Bs[st][r][kk], ok ? wp + (size_t)n * Kw + k : wp,
                        ok ? VEC * 4 : 0);
    }
    for (int c = tid; c < TBM * CPR; c += THREADS) {
      const int r = c / CPR, kk = (c % CPR) * VEC, m = m0 + r, k = k0 + kk;
      const bool ok = m < M && k < ke;
      cp_async<VEC * 4>(&As[st][r][kk], ok ? xp + (size_t)m * lda + k : xp,
                        ok ? VEC * 4 : 0);
    }
  };

  int acc[2][NI][4];
  int pa[2][2] = {{0, 0}, {0, 0}}, pb[NI];        // row / column popcounts
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    pb[j] = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  }
  const bool live[2] = {m0 + wm < M, m0 + wm + 16 < M};   // warp-uniform

  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) load_tile(st ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kend = min(TKW, ke - kb - kt * TKW);
    if (live[0]) {
      for (int k8 = 0; k8 < kend; k8 += 8) {
        uint32_t b[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint32_t* row = Bs[st][wn + ni * 8 + g];
          b[ni][0] = row[k8 + t];
          b[ni][1] = row[k8 + 4 + t];
          pb[ni] += __popc(b[ni][0]) + __popc(b[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (!live[mi]) continue;
          const uint32_t* r0 = As[st][wm + mi * 16 + g];
          const uint32_t* r1 = As[st][wm + mi * 16 + 8 + g];
          const uint32_t a[4] = {r0[k8 + t], r1[k8 + t], r0[k8 + 4 + t],
                                 r1[k8 + 4 + t]};
          pa[mi][0] += __popc(a[0]) + __popc(a[2]);
          pa[mi][1] += __popc(a[1]) + __popc(a[3]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_b1_and(acc[mi][ni], a, b[ni][0], b[ni][1]);
        }
      }
    }
    __syncthreads();                              // stage st consumed
  }

  // acc counts positions where both bits are 1; the 4 lanes t of a row
  // (column) hold parts of its popcount; mismatches = pa + pb - 2 acc
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pa[mi][h] += __shfl_xor_sync(0xffffffffu, pa[mi][h], off);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      pb[ni] += __shfl_xor_sync(0xffffffffu, pb[ni], off);
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    // column 2t + e of this fragment is lane (2t + e) * 4's column g
    const int pbc[2] = {__shfl_sync(0xffffffffu, pb[ni], (2 * t) * 4),
                        __shfl_sync(0xffffffffu, pb[ni], (2 * t + 1) * 4)};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][ni][e] = pa[mi][e >> 1] + pbc[e & 1] - 2 * acc[mi][ni][e];
  }

  if constexpr (SPLIT) {
    // publish this part's counts; the last part of the tile to arrive
    // adds the others' to its own, at its own fragment positions
    __shared__ int last;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const size_t tiles = (size_t)gridDim.x * gridDim.y;
    auto slot = [&](int p, int mi, int ni, int h) {
      return reinterpret_cast<int2*>(
          part + ((size_t)p * tiles + tile) * TBM * BN +
          (wm + mi * 16 + g + 8 * h) * BN + wn + ni * 8 + 2 * t);
    };
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          __stcg(slot(blockIdx.z, mi, ni, h),
                 make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]));
    __syncthreads();
    if (tid == 0) {
      int* ctr = counters + tile;
      int old;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(old) : "l"(ctr) : "memory");
      last = old == (int)gridDim.z - 1;
      if (last) *ctr = 0;                       // every part has arrived
    }
    __syncthreads();
    if (!last) return;
#pragma unroll 2
    for (int p = 0; p < (int)gridDim.z; ++p) {
      if (p == (int)blockIdx.z) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int2 v = __ldcg(slot(p, mi, ni, h));
            acc[mi][ni][2 * h] += v.x;
            acc[mi][ni][2 * h + 1] += v.y;
          }
    }
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (m < M && n < N)
          bnn_store(out, (size_t)m * N + n, S - acc[mi][ni][e], S, alpha, n,
                    mode);
      }
}

// One launch of the tensor-core route on `stream`: bn-column tiles,
// `parts` blocks per tile over kpart words each (parts > 1 only at
// bn = 32, with a (parts, tiles, TBM x 32) int scratch and the tiles'
// counters; both unused at parts == 1).
template <int VEC>
inline cudaError_t launch_tc(const uint32_t* xp, const uint32_t* wp,
                             const float* alpha, void* out, int* part,
                             int* counters, int M, int N, int S, int Kw,
                             int lda, int bn, int parts, int kpart, int mode,
                             cudaStream_t stream) {
  const dim3 grid((N + bn - 1) / bn, (M + TBM - 1) / TBM, parts);
  const auto k = parts > 1 ? tc_kernel<VEC, 32, true>
                 : bn == 32 ? tc_kernel<VEC, 32, false>
                            : tc_kernel<VEC, 64, false>;
  k<<<grid, THREADS, 0, stream>>>(xp, wp, alpha, out, part, counters, M, N,
                                  S, Kw, lda, kpart, mode);
  return cudaGetLastError();
}

}  // namespace bnn_gemm
