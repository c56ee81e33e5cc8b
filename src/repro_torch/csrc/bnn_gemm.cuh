// The packed x packed BNN GEMM core on tensor cores:
// (M, KwP) packed activations  x  (N, Kw) packed weights  ->  (M, N),
// z = S - popcount(a ^ w) per element, stored through bnn_epilogue.cuh.
// fused_bnn.cu runs it after its pack launch; it takes any packed pair.
//
// A block owns a 64 x BN output tile (BN = 64, or 32 where 64-wide
// tiles would not fill the card), four warps of 32 x BN/2; K runs in
// tiles of 32 words (1024 bits) staged with cp.async, double-buffered.
// The product is mma.m16n8k256.b1 with AND + popcount on the packed
// words as they are, 8 words per step: the row and column popcounts,
// summed as the fragments load, turn the both-one count c into
// mismatches pa + pb - 2c.  Bits past S are 0 on both sides (the pack
// writes them so, and the words up to KwP are zero-filled), so they
// count nowhere.
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

// xp rows are KwP words (KwP % 4 == 0, 16-byte aligned); wp rows are Kw
// words, loaded VEC words at a time (Kw % VEC == 0).
template <int VEC, int BN>
__global__ __launch_bounds__(THREADS) void tc_kernel(
    const uint32_t* __restrict__ xp, const uint32_t* __restrict__ wp,
    const float* __restrict__ alpha, void* __restrict__ out, int M, int N,
    int S, int Kw, int KwP, int mode) {
  constexpr int NI = BN / 16;                     // n fragments per warp
  __shared__ __align__(16) uint32_t As[2][TBM][LDW];
  __shared__ __align__(16) uint32_t Bs[2][BN][LDW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BN / 2);
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * BN;
  const int nk = (KwP + TKW - 1) / TKW;

  auto load_tile = [&](int st, int kt) {
    const int k0 = kt * TKW;
    constexpr int CPR = TKW / VEC;                 // chunks per row
    for (int c = tid; c < BN * CPR; c += THREADS) {
      const int r = c / CPR, kk = (c % CPR) * VEC, n = n0 + r, k = k0 + kk;
      const bool ok = n < N && k < Kw;
      cp_async<VEC * 4>(&Bs[st][r][kk], ok ? wp + (size_t)n * Kw + k : wp,
                        ok ? VEC * 4 : 0);
    }
    for (int c = tid; c < TBM * (TKW / 4); c += THREADS) {
      const int r = c / (TKW / 4), kk = (c % (TKW / 4)) * 4;
      const int m = m0 + r, k = k0 + kk;
      const bool ok = m < M && k < KwP;
      cp_async<16>(&As[st][r][kk], ok ? xp + (size_t)m * KwP + k : xp,
                   ok ? 16 : 0);
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
    const int kend = min(TKW, KwP - kt * TKW);
    if (live[0]) {
      for (int k8 = 0; k8 < kend; k8 += 8) {
        // every stage is staged full width: words past KwP (and past Kw
        // in the weight) are cp.async's zero fill
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
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + ni * 8 + 2 * t + (e & 1);
        const int z = S - (pa[mi][e >> 1] + pbc[e & 1] - 2 * acc[mi][ni][e]);
        if (m < M && n < N)
          bnn_store(out, (size_t)m * N + n, z, S, alpha, n, mode);
      }
  }
}

// One launch of the core on `stream`; 32-column tiles where 64-column
// ones would give fewer blocks than the card has SMs.
template <int VEC>
inline cudaError_t launch_tc(const uint32_t* xp, const uint32_t* wp,
                             const float* alpha, void* out, int M, int N,
                             int S, int Kw, int KwP, int mode, int sm_count,
                             cudaStream_t stream) {
  const int mt = (M + TBM - 1) / TBM;
  const bool narrow = mt * ((N + 63) / 64) < sm_count;
  const int bn = narrow ? 32 : 64;
  const dim3 grid((N + bn - 1) / bn, mt);
  const auto k = narrow ? tc_kernel<VEC, 32> : tc_kernel<VEC, 64>;
  k<<<grid, THREADS, 0, stream>>>(xp, wp, alpha, out, M, N, S, Kw, KwP, mode);
  return cudaGetLastError();
}

}  // namespace bnn_gemm
