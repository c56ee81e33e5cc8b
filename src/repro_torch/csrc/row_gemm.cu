// Fixed-order float32 GEMM: y (M, N) = x (M, K) @ w (K, N).
//
// Replaces no Pallas kernel.  It stands for the plain float GEMMs the
// JAX package leaves to XLA where a row must come out the same whatever
// runs beside it: the LM head's einsum (src/repro/models/transformer.py
// logits_fn) and the MoE router's (src/repro/layers/moe.py route).
// Over a (data, model) mesh a rank multiplies its own rows by its own
// vocab slice of the head; a library GEMM picks its algorithm, and so
// its sums' order, by M and N (cuBLAS rounded mixtral's head over half
// the vocab 8.1e-6 away from the whole), so the ranks' logits would not
// be one rank's.
//
// The order: K-chunks of KC = 256.  For chunk c (k in [c KC, c KC +
// KC) and below K)
//     P_c = +0.0;  for k ascending:  P_c = __fadd_rn(P_c, __fmul_rn(x[m][k], w[k][n]));
// and then y[m][n] = +0.0 + P_0 + P_1 + ..., added in ascending c, each
// add rounded.  Every product is rounded, then every add (nvcc would
// contract a*b+c into an FMA by default).  The order depends on K
// alone, so a y[m][n]'s bits depend on row m of x and column n of w
// alone: not on M, N, which columns of a larger w these are, the grid
// or the tile.  For K <= KC it is the single chain over k (+0.0 + P_0
// = P_0): the reduced configs' d_model and every CPU expectation kept
// their bits when the chunks came in.  k positions past K hold zeros
// on both sides; a partial or a total is never -0.0 (each starts at
// +0.0, and a sum is -0.0 only when both terms are), so adding their
// +-0.0 products, or a chunk of them, leaves it unchanged.
// kernels/rowwise.row_gemm_torch repeats the order with torch ops and
// equals this bit for bit.
//
// Why no FMA: a fused chain would halve the prefill floor below, but
// the plain version must repeat the kernel exactly, and torch repeats
// a float32 FMA only through a float64 product, TwoSum and round to
// odd, which cost many times the separate ops on the CPU at the
// reduced configs' shapes (the plain version runs in every CPU forward
// of the tests).  Why no tensor cores: their float32 (TF32 x 3) sums
// truncate, and no plain version could repeat their order.
//
// w is read through its strides (sk, sn), so the tied head, the
// embedding's transposed view (sk = 1, sn = d), needs no copy.
//
// Three regimes, one launch a call each:
//   * routers (N <= 64): the work is tiny (w is 128-512 KB, in L2), and
//     one thread's chain over all of K was the floor (K dependent adds:
//     4096 at mixtral).  The fixed chunks let the sum split
//     over K: a cluster of up to 8 blocks (Hopper's distributed shared
//     memory) takes a tile of up to 8 rows and 8-32 columns, its
//     block of rank r the chunks r, r + 8, ...; a block copies its x
//     and w slabs into shared memory with cp.async (16 bytes along w's
//     unit-stride dim; power-of-2 tiles, so no divisions in the copy
//     loops), a thread runs one chunk's chain for 1, 2 or 4 columns,
//     and after a cluster barrier each block gathers its outputs'
//     partials from across the cluster in one parallel pass and adds
//     them in ascending c.  Floor: launch latency, one round trip for
//     the slabs, one chunk's chain (256 dependent adds), two cluster
//     barriers.
//   * decode heads (M <= 32): bound by one read of w (mixtral's 4096 x
//     32000 head: 524 MB, 156 us at 3.35 TB/s).  A block takes 32 to
//     256 columns, a thread a column and all M rows (two threads a
//     column, each half the rows, from 5 rows); w and x tiles of BK =
//     16, 32 or 64 k stream through a ring of 4 shared-memory stages by
//     cp.async, 16-byte copies (w's rows for a dense (K, N); its
//     columns, k contiguous, for the tied layout), so three tiles are
//     in flight while one is summed.  Width and depth follow the tile
//     count against the SMs (decode::launch), so that each SM keeps
//     about 100 KB in flight; a dense half vocab at few rows splits
//     each tile's chunks over a cluster of 2 and adds the partials
//     across it as the routers do.
//   * prefill heads (M > 32): bound by the 2 M N K operations at the
//     float32 data-sheet rate (33.5 G for mixtral's head at M = 128,
//     0.50 ms), which counts an FMA as two; separate products and adds
//     issue twice the instructions, so 2x that bound is this order's
//     floor.  128 x 128 block tiles, 256 threads of 8 x 8 sums, k
//     tiles of 16 in a 3-stage ring: a dense w by cp.async, x (and the
//     tied layout's w) through registers a tile ahead, stored k-major
//     and XOR-swizzled (no padding, no bank conflicts), so a thread
//     reads 16 bytes of x and of w a load: 4 shared loads per 128
//     products and adds.
//     A thread keeps its chunk partials in registers and adds them to
//     its running totals every KC steps: in registers where the tiles
//     fit in one wave, in shared memory (two blocks, 16 warps an SM)
//     where they outnumber the SMs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KC = 256;       // the order's K-chunk (kernels/rowwise.KC)

__device__ __forceinline__ float mad(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// cp.async of 16 or 4 bytes; !ok zero-fills (src, a valid address, is
// not read)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the two halves of a cluster barrier: a block arrives when it is done
// reading the others' shared memory, and waits before it exits
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

int sm_count() {
  static int count[dyn_smem::MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 ||
      dev >= dyn_smem::MAX_DEVICES)
    return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return count[dev];
}

// ------------------------------------------------------------- routers

namespace router {

constexpr int XS = KC + 4;        // an x slab row (floats): 16-byte rows,
                                  // rows 4 banks apart
constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 8;
constexpr size_t MAX_SMEM = 200 * 1024;

// A cluster of cs blocks (a power of 2 up to 8) takes a tile of bm rows
// (1, 2, 4 or 8) and BN columns (8, 16 or 32); its block of
// rank r sums the chunks c = r + cs j, j < cpb.  Shared memory (floats):
// xs[cpb][bm][XS] | ws[cpb][KC][BN] | part[cpb][bm][BN]; after the
// chains xs holds the gathered partials of the block's outputs.
template <int BN, int TN>
__global__ void __launch_bounds__(THREADS)
router_kernel(const float* __restrict__ x, const float* __restrict__ w,
       float* __restrict__ y, int M, int N, int K, long long sk,
       long long sn, int lbm, int cpb, int col_tiles, bool xv, bool wv) {
  extern __shared__ float4 smem4[];
  const int bm = 1 << lbm;
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + cpb * bm * XS;
  float* part = ws + cpb * KC * BN;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int C = (K + KC - 1) / KC;
  const int tile = blockIdx.x / cs;
  const int m0 = (tile / col_tiles) * bm, n0 = (tile % col_tiles) * BN;
  const int t = threadIdx.x;

  for (int j = 0; j < cpb; ++j) {             // the slabs of chunk r + cs j
    const int c = r + cs * j;
    if (c >= C) break;
    const int k0 = c * KC;
    if (xv) {
      for (int q = t; q < bm * KC / 4; q += THREADS) {
        const int i = q / (KC / 4), k = k0 + 4 * (q % (KC / 4));
        const bool ok = m0 + i < M && k < K;
        cp16(xs + (j * bm + i) * XS + k - k0,
             ok ? x + (long long)(m0 + i) * K + k : x, ok);
      }
    } else {
      for (int q = t; q < bm * KC; q += THREADS) {
        const int i = q / KC, k = k0 + q % KC;
        const bool ok = m0 + i < M && k < K;
        cp4(xs + (j * bm + i) * XS + k - k0,
            ok ? x + (long long)(m0 + i) * K + k : x, ok);
      }
    }
    if (wv) {
      for (int q = t; q < KC * BN / 4; q += THREADS) {
        const int kk = q / (BN / 4), nn = 4 * (q % (BN / 4));
        const int k = k0 + kk, n = n0 + nn;
        const bool ok = k < K && n < N;
        cp16(ws + (j * KC + kk) * BN + nn, ok ? w + k * sk + n : w, ok);
      }
    } else {
      for (int q = t; q < KC * BN; q += THREADS) {
        const int kk = q / BN, nn = q % BN, k = k0 + kk, n = n0 + nn;
        const bool ok = k < K && n < N;
        cp4(ws + (j * KC + kk) * BN + nn, ok ? w + k * sk + n * sn : w, ok);
      }
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // a thread a (chunk, row, TN columns) chain: P_c over the chunk's k
  constexpr int G = BN / TN;
  for (int ch = t; ch < (cpb * G) << lbm; ch += THREADS) {
    const int g = ch % G, i = (ch / G) & (bm - 1), j = (ch / G) >> lbm;
    if (r + cs * j >= C || m0 + i >= M) continue;
    const float* xr = xs + (j * bm + i) * XS;
    const float* wr = ws + j * KC * BN + g * TN;
    float acc[TN];
#pragma unroll
    for (int u = 0; u < TN; ++u) acc[u] = 0.f;
#pragma unroll 16
    for (int kk = 0; kk < KC; kk += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xr + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* b = wr + (kk + e) * BN;
        if constexpr (TN == 1) {
          acc[0] = mad(acc[0], elem(a, e), b[0]);
        } else if constexpr (TN == 2) {
          const float2 v = *reinterpret_cast<const float2*>(b);
          acc[0] = mad(acc[0], elem(a, e), v.x);
          acc[1] = mad(acc[1], elem(a, e), v.y);
        } else {
          const float4 v = *reinterpret_cast<const float4*>(b);
          acc[0] = mad(acc[0], elem(a, e), v.x);
          acc[1] = mad(acc[1], elem(a, e), v.y);
          acc[2] = mad(acc[2], elem(a, e), v.z);
          acc[3] = mad(acc[3], elem(a, e), v.w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TN; ++u) part[(j * bm + i) * BN + g * TN + u] = acc[u];
  }
  cluster.sync();                        // every chunk's partials are ready

  // the block's outputs (per of the tile's bm x BN, a power of 2) gather
  // their partials from across the cluster in one parallel pass ...
  const int lcs = __ffs(cs) - 1;
  const int lper = (__ffs(BN) - 1) + lbm - lcs;     // >= 0: cs <= 8 <= BN
  const int per = 1 << lper, o0 = r * per;
  float* gath = xs;                                 // [C][per]
  for (int q = t; q < C << lper; q += THREADS) {
    const int c = q >> lper, o = o0 + (q & (per - 1));
    const float* p = cluster.map_shared_rank(part, c & (cs - 1));
    gath[q] = p[((c >> lcs) * bm + o / BN) * BN + o % BN];
  }
  __syncthreads();
  cluster_arrive();                              // done reading the others
  // ... and sum them in ascending chunk order from +0.0
  for (int ol = t; ol < per; ol += THREADS) {
    const int o = o0 + ol, m = m0 + o / BN, n = n0 + o % BN;
    if (m >= M || n >= N) continue;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = __fadd_rn(s, gath[(c << lper) + ol]);
    y[(long long)m * N + n] = s;
  }
  cluster_wait();                  // no block leaves while its partials are read
}

template <int BN, int TN>
cudaError_t launch_tn(int grid, size_t smem, int cs, cudaStream_t st,
                      const float* x, const float* w, float* y, int M, int N,
                      int K, long long sk, long long sn, int lbm, int cpb,
                      int col_tiles, bool xv, bool wv) {
  static size_t granted[dyn_smem::MAX_DEVICES] = {};
  cudaError_t err =
      dyn_smem::opt_in(router_kernel<BN, TN>, smem, granted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, router_kernel<BN, TN>, x, w, y, M, N, K,
                            sk, sn, lbm, cpb, col_tiles, xv, wv);
}

template <int BN>
cudaError_t launch_bn(int tn, int grid, size_t smem, int cs, cudaStream_t st,
                      const float* x, const float* w, float* y, int M, int N,
                      int K, long long sk, long long sn, int lbm, int cpb,
                      int col_tiles, bool xv, bool wv) {
  if (tn == 1)
    return launch_tn<BN, 1>(grid, smem, cs, st, x, w, y, M, N, K, sk, sn, lbm,
                            cpb, col_tiles, xv, wv);
  if (tn == 2)
    return launch_tn<BN, 2>(grid, smem, cs, st, x, w, y, M, N, K, sk, sn, lbm,
                            cpb, col_tiles, xv, wv);
  return launch_tn<BN, 4>(grid, smem, cs, st, x, w, y, M, N, K, sk, sn, lbm,
                          cpb, col_tiles, xv, wv);
}

// false: the slabs do not fit (a K too long for a cluster's shared
// memory); the caller takes the head kernels, which fit any K
bool launch(const float* x, const float* w, float* y, int M, int N, int K,
            long long sk, long long sn, bool xv, bool wv, cudaStream_t st,
            cudaError_t* err) {
  const int C = (K + KC - 1) / KC;
  int cs = 1;
  while (cs * 2 <= C && cs * 2 <= MAX_CLUSTER) cs *= 2;
  const int cpb = (C + cs - 1) / cs;
  // a row: narrow tiles, more blocks to share K; many rows: wide ones
  int bn = 8;
  while (bn < N && bn < (M == 1 ? 8 : M <= 8 ? 16 : 32)) bn *= 2;
  int lbm = 0;
  while ((1 << lbm) < M && lbm < 3) ++lbm;
  auto bytes = [&](int l) {
    return sizeof(float) * cpb * (((size_t)XS << l) + (size_t)KC * bn +
                                  ((size_t)bn << l));
  };
  while (lbm > 0 && bytes(lbm) > MAX_SMEM) --lbm;
  if (bytes(lbm) > MAX_SMEM) return false;
  const int chains = (cpb * bn) << lbm;
  const int tn = chains > 2 * THREADS ? 4 : chains > THREADS ? 2 : 1;
  const int col_tiles = (N + bn - 1) / bn;
  const long long grid =
      (long long)cs * col_tiles * ((M + (1 << lbm) - 1) >> lbm);
  if (grid > 0x7fffffffLL) {
    *err = cudaErrorInvalidValue;
    return true;
  }
  const size_t smem = bytes(lbm);
  *err = bn == 8    ? launch_bn<8>(tn, (int)grid, smem, cs, st, x, w, y, M,
                                   N, K, sk, sn, lbm, cpb, col_tiles, xv, wv)
         : bn == 16 ? launch_bn<16>(tn, (int)grid, smem, cs, st, x, w, y, M,
                                    N, K, sk, sn, lbm, cpb, col_tiles, xv, wv)
                    : launch_bn<32>(tn, (int)grid, smem, cs, st, x, w, y, M,
                                    N, K, sk, sn, lbm, cpb, col_tiles, xv, wv);
  return true;
}

}  // namespace router

// -------------------------------------------------------- decode heads

namespace decode {

constexpr int STAGES = 4;
constexpr size_t MAX_SPLIT_SMEM = 200 * 1024;

// A stage: xs[MR][BK + 4] | ws (dense [BK][BN]; tied [BN][BK + 4]); the
// +4 keeps 16-byte rows and spreads 8 rows' 16-byte reads over 8 bank
// groups.  BK (16, 32 or 64, a divisor of KC) sets the bytes in flight:
// deeper where fewer blocks share an SM.  RS threads a column, each
// MR / RS of the rows.
template <int MR, int RS, bool TIED, int BN, bool SPLIT>
__global__ void __launch_bounds__(BN * RS)
decode_kernel(const float* __restrict__ x, const float* __restrict__ w,
       float* __restrict__ y, int M, int N, int K, long long sk,
       long long sn, bool xv, bool wv, int BK) {
  constexpr int THREADS = BN * RS, RT = MR / RS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int KS = BK + 4;
  const int SF = MR * KS + (TIED ? BN * KS : BK * BN);
  const int t = threadIdx.x, col = t % BN, r0 = (t / BN) * RT;
  const int tpc = KC / BK, C = (K + KC - 1) / KC;
  // SPLIT: a cluster of cs blocks shares the tile, block r the chunks
  // r + cs j; its k tiles are those chunks' in turn
  int cs = 1, r = 0;
  if constexpr (SPLIT) {
    cs = (int)cg::this_cluster().num_blocks();
    r = (int)cg::this_cluster().block_rank();
  }
  const int n0 = (blockIdx.x / cs) * BN;
  const int cpb = (C + cs - 1) / cs, nj = C > r ? (C - r + cs - 1) / cs : 0;
  const int ntiles = SPLIT ? nj * tpc : (K + BK - 1) / BK;
  float* part = smem + STAGES * SF;               // SPLIT: [cpb][MR][BN]

  auto load = [&](int s, int kt) {
    const int k0 = SPLIT ? (r + cs * (kt / tpc)) * KC + (kt % tpc) * BK
                         : kt * BK;
    const int kv = BK / 4;
    float* xd = smem + s * SF;
    float* wd = xd + MR * KS;
    if (xv) {
      for (int q = t; q < MR * kv; q += THREADS) {
        const int i = q / kv, k = k0 + 4 * (q % kv);
        const bool ok = i < M && k < K;
        cp16(xd + i * KS + k - k0, ok ? x + (long long)i * K + k : x, ok);
      }
    } else {
      for (int q = t; q < MR * BK; q += THREADS) {
        const int i = q / BK, k = k0 + q % BK;
        const bool ok = i < M && k < K;
        cp4(xd + i * KS + k - k0, ok ? x + (long long)i * K + k : x, ok);
      }
    }
    if constexpr (TIED) {            // w's columns: k contiguous
      if (wv) {
        for (int q = t; q < BN * kv; q += THREADS) {
          const int nn = q / kv, k = k0 + 4 * (q % kv), n = n0 + nn;
          const bool ok = n < N && k < K;
          cp16(wd + nn * KS + k - k0, ok ? w + n * sn + k : w, ok);
        }
      } else {
        for (int q = t; q < BN * BK; q += THREADS) {
          const int nn = q / BK, k = k0 + q % BK, n = n0 + nn;
          const bool ok = n < N && k < K;
          cp4(wd + nn * KS + k - k0, ok ? w + n * sn + k * sk : w, ok);
        }
      }
    } else {                         // w's rows: n contiguous
      if (wv) {
        for (int q = t; q < BK * BN / 4; q += THREADS) {
          const int kk = q / (BN / 4), nn = 4 * (q % (BN / 4));
          const int k = k0 + kk, n = n0 + nn;
          const bool ok = k < K && n < N;
          cp16(wd + kk * BN + nn, ok ? w + k * sk + n : w, ok);
        }
      } else {
        for (int q = t; q < BK * BN; q += THREADS) {
          const int kk = q / BN, nn = q % BN, k = k0 + kk, n = n0 + nn;
          const bool ok = k < K && n < N;
          cp4(wd + kk * BN + nn, ok ? w + k * sk + n * sn : w, ok);
        }
      }
    }
  };

  float acc[RT], tot[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i] = tot[i] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < ntiles)
      load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_commit();
    const float* xd = smem + (kt % STAGES) * SF + r0 * KS;
    const float* wd = smem + (kt % STAGES) * SF + MR * KS;
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float b[4];
      if constexpr (TIED) {
        const float4 q = *reinterpret_cast<const float4*>(wd + col * KS + kk);
        b[0] = q.x; b[1] = q.y; b[2] = q.z; b[3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = wd[(kk + e) * BN + col];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(xd + i * KS + kk);
        acc[i] = mad(acc[i], a.x, b[0]);
        acc[i] = mad(acc[i], a.y, b[1]);
        acc[i] = mad(acc[i], a.z, b[2]);
        acc[i] = mad(acc[i], a.w, b[3]);
      }
    }
    if ((kt + 1) % tpc == 0 || kt == ntiles - 1) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        if constexpr (SPLIT)
          part[((kt / tpc) * MR + r0 + i) * BN + col] = acc[i];
        else
          tot[i] = __fadd_rn(tot[i], acc[i]);
        acc[i] = 0.f;
      }
    }
  }
  if constexpr (SPLIT) {
    // the cluster's partials: each block gathers those of its share of
    // the tile's outputs, then adds them in ascending chunk order
    cg::this_cluster().sync();
    const int outs = MR * BN, per = (outs + cs - 1) / cs, o0 = r * per;
    const int mine = o0 < outs ? (outs - o0 < per ? outs - o0 : per) : 0;
    float* gath = part + cpb * MR * BN;           // [C][per]
    for (int q = t; q < C * mine; q += THREADS) {
      const int c = q / mine, o = o0 + q % mine;
      const float* p = cg::this_cluster().map_shared_rank(part, c % cs);
      gath[c * per + q % mine] = p[(c / cs) * MR * BN + o];
    }
    __syncthreads();
    cluster_arrive();
    for (int ol = t; ol < mine; ol += THREADS) {
      const int o = o0 + ol, i = o / BN, n = n0 + o % BN;
      if (i >= M || n >= N) continue;
      float s = 0.f;
      for (int c = 0; c < C; ++c) s = __fadd_rn(s, gath[c * per + ol]);
      y[(long long)i * N + n] = s;
    }
    cluster_wait();
    return;
  }
  const int n = n0 + col;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (r0 + i < M) y[(long long)(r0 + i) * N + n] = tot[i];
}

template <int MR, int RS, bool TIED, int BN>
cudaError_t launch_bn(const float* x, const float* w, float* y, int M, int N,
                      int K, long long sk, long long sn, bool xv, bool wv,
                      cudaStream_t st, int BK, int cs) {
  const int tiles = (N + BN - 1) / BN, C = (K + KC - 1) / KC;
  if (cs > C) cs = C;
  size_t smem = sizeof(float) * STAGES *
      (MR * (BK + 4) + (TIED ? BN * (BK + 4) : BK * BN));
  if (cs <= 1) {
    static size_t granted[dyn_smem::MAX_DEVICES] = {};
    const auto k = decode_kernel<MR, RS, TIED, BN, false>;
    const cudaError_t err = dyn_smem::opt_in(k, smem, granted);
    if (err != cudaSuccess) return err;
    k<<<tiles, BN * RS, smem, st>>>(x, w, y, M, N, K, sk, sn, xv, wv, BK);
    return cudaGetLastError();
  }
  const int cpb = (C + cs - 1) / cs, per = (MR * BN + cs - 1) / cs;
  const size_t split = smem + sizeof(float) * ((size_t)cpb * MR * BN +
                                               (size_t)C * per);
  if (split > MAX_SPLIT_SMEM)          // a K too long to keep its partials
    return launch_bn<MR, RS, TIED, BN>(x, w, y, M, N, K, sk, sn, xv, wv, st,
                                       BK, 1);
  smem = split;
  static size_t granted[dyn_smem::MAX_DEVICES] = {};
  const auto k = decode_kernel<MR, RS, TIED, BN, true>;
  cudaError_t err = dyn_smem::opt_in(k, smem, granted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cs);
  cfg.blockDim = dim3(BN * RS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k, x, w, y, M, N, K, sk, sn, xv, wv, BK);
}

// The tile for the rows, the layout and the grid, from a sweep of
// widths, depths, row splits and cluster splits over the main paths'
// heads on the H100 (chip_smoke.py phase 2 times the choice): dense
// heads 256 columns, 32 where few tiles must feed 8 rows; the tied
// head 128 (64 for a half vocab at few rows); deeper k where fewer
// blocks share an SM; two threads a column from 5 rows; a half vocab's
// dense head at few rows split over a cluster of 2 by chunks.
template <int MR, bool TIED>
cudaError_t launch(const float* x, const float* w, float* y, int M, int N,
                   int K, long long sk, long long sn, bool xv, bool wv,
                   cudaStream_t st) {
  const int sms = sm_count(), t128 = (N + 127) / 128;
  constexpr int RS = MR <= 4 ? 1 : 2;
  if constexpr (TIED) {
    if (t128 > sms)
      return launch_bn<MR, RS, true, 128>(x, w, y, M, N, K, sk, sn, xv, wv,
                                          st, 32, 1);
    if constexpr (MR <= 4)
      return launch_bn<MR, 1, true, 64>(x, w, y, M, N, K, sk, sn, xv, wv, st,
                                        64, 1);
    else
      return launch_bn<MR, 2, true, 128>(x, w, y, M, N, K, sk, sn, xv, wv,
                                         st, 64, 1);
  } else {
    if (t128 > 2 * sms)
      return launch_bn<MR, 1, false, 256>(x, w, y, M, N, K, sk, sn, xv, wv,
                                          st, MR <= 4 ? 32 : 16, 1);
    if (t128 > sms)
      return launch_bn<MR, RS, false, 256>(x, w, y, M, N, K, sk, sn, xv, wv,
                                           st, 32, 1);
    if constexpr (MR <= 4)
      return launch_bn<MR, 1, false, 256>(x, w, y, M, N, K, sk, sn, xv, wv,
                                          st, 32, 2);
    else
      return launch_bn<MR, 2, false, 32>(x, w, y, M, N, K, sk, sn, xv, wv,
                                         st, 64, 1);
  }
}

template <bool TIED>
cudaError_t rows(const float* x, const float* w, float* y, int M, int N,
                 int K, long long sk, long long sn, bool xv, bool wv,
                 cudaStream_t st) {
  if (M == 1) return launch<1, TIED>(x, w, y, M, N, K, sk, sn, xv, wv, st);
  if (M == 2) return launch<2, TIED>(x, w, y, M, N, K, sk, sn, xv, wv, st);
  if (M <= 4) return launch<4, TIED>(x, w, y, M, N, K, sk, sn, xv, wv, st);
  if (M <= 8) return launch<8, TIED>(x, w, y, M, N, K, sk, sn, xv, wv, st);
  if (M <= 16) return launch<16, TIED>(x, w, y, M, N, K, sk, sn, xv, wv, st);
  return launch<32, TIED>(x, w, y, M, N, K, sk, sn, xv, wv, st);
}

}  // namespace decode


// ------------------------------------------------------- prefill heads

namespace prefill {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256, STAGES = 3;
constexpr int TILE = BK * 128;        // floats of a k-major tile

// (k, col) of a k-major tile written through registers: the 4-float
// quad of col XOR-ed with 2 ((k / 4) mod 4), so the transposing stores
// of a warp (8 rows x 4 k-quads) hit 32 banks and a 16-byte read of 4
// consecutive cols stays contiguous
__device__ __forceinline__ int swz(int k, int col) {
  return k * 128 + ((((col >> 2) ^ (((k >> 2) & 3) << 1))) << 2) + (col & 3);
}

// a 128 x BK tile of a matrix whose rows are contiguous over k (x, or
// the tied w's columns): element (r, k) at p + r * ld + k * kstride;
// a thread's 8 floats, 2 x 16 bytes where vec
__device__ __forceinline__ void load_rows(float (&v)[8], const float* p,
                                          long long ld, long long kstride,
                                          int rows, int r0, int K, int k0,
                                          bool vec, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = t + h * THREADS, rr = r0 + q / 4, k = k0 + 4 * (q % 4);
    if (vec) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rr < rows && k < K)
        f = *reinterpret_cast<const float4*>(p + rr * ld + k);
      v[4 * h] = f.x; v[4 * h + 1] = f.y; v[4 * h + 2] = f.z;
      v[4 * h + 3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[4 * h + e] = rr < rows && k + e < K
                           ? p[rr * ld + (long long)(k + e) * kstride] : 0.f;
    }
  }
}

__device__ __forceinline__ void store_kmajor(float* tile, const float (&v)[8],
                                             int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = t + h * THREADS, rr = q / 4, kq = q % 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[swz(4 * kq + e, rr)] = v[4 * h + e];
  }
}

// Shared memory: xs[STAGES][TILE] | ws[STAGES][TILE] (| TS: tots[64]
// [THREADS]); x k-major swizzled; w k-major, swizzled for the tied
// layout, plain for a dense (K, N) (copied by cp.async as it lies).
// TS: the running totals in shared memory, not registers, so that two
// blocks (16 warps) share an SM where the tiles outnumber the SMs.
template <bool TIED, bool TS>
__global__ void __launch_bounds__(THREADS, TS ? 2 : 1)
prefill_kernel(const float* __restrict__ x, const float* __restrict__ w,
       float* __restrict__ y, int M, int N, int K, long long sk,
       long long sn, bool xv, bool wv) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + STAGES * TILE;
  float* tots = ws + STAGES * TILE;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ntiles = (K + BK - 1) / BK;

  auto copy_w = [&](int s, int kt) {        // dense w by cp.async
    const int k0 = kt * BK;
    float* wd = ws + s * TILE;
    if (wv) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = t + h * THREADS, kk = q / 32, nn = 4 * (q % 32);
        const int k = k0 + kk, n = n0 + nn;
        const bool ok = k < K && n < N;
        cp16(wd + kk * BN + nn, ok ? w + k * sk + n : w, ok);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int q = t + h * THREADS, kk = q / BN, nn = q % BN;
        const int k = k0 + kk, n = n0 + nn;
        const bool ok = k < K && n < N;
        cp4(wd + kk * BN + nn, ok ? w + k * sk + n * sn : w, ok);
      }
    }
  };
  float xr[8], wr[8];
  auto fetch = [&](int kt) {                // the next tile into registers
    load_rows(xr, x, K, 1, M, m0, K, kt * BK, xv, t);
    if constexpr (TIED) load_rows(wr, w, sn, sk, N, n0, K, kt * BK, wv, t);
  };
  auto stash = [&](int s) {
    store_kmajor(xs + s * TILE, xr, t);
    if constexpr (TIED) store_kmajor(ws + s * TILE, wr, t);
  };

  float acc[8][8], tot[TS ? 1 : 8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
      if constexpr (TS) tots[(i * 8 + j) * THREADS + t] = 0.f;
      else tot[i][j] = 0.f;
    }

  if (ntiles > 0) {
    fetch(0);
    stash(0);
    if constexpr (!TIED) copy_w(0, 0);
  }
  cp_commit();
  if constexpr (!TIED) {
    if (ntiles > 1) copy_w(1, 1);
  }
  cp_commit();
  if (ntiles > 1) fetch(1);

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_wait<1>();
    __syncthreads();
    if constexpr (!TIED) {
      if (kt + 2 < ntiles) copy_w((kt + 2) % STAGES, kt + 2);
    }
    cp_commit();
    if (kt + 1 < ntiles) stash((kt + 1) % STAGES);
    if (kt + 2 < ntiles) fetch(kt + 2);
    const float* xt = xs + (kt % STAGES) * TILE;
    const float* wt = ws + (kt % STAGES) * TILE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xt + swz(kk, 4 * ty));
      const float4 a1 =
          *reinterpret_cast<const float4*>(xt + swz(kk, 64 + 4 * ty));
      float4 b0, b1;
      if constexpr (TIED) {
        b0 = *reinterpret_cast<const float4*>(wt + swz(kk, 4 * tx));
        b1 = *reinterpret_cast<const float4*>(wt + swz(kk, 64 + 4 * tx));
      } else {
        b0 = *reinterpret_cast<const float4*>(wt + kk * BN + 4 * tx);
        b1 = *reinterpret_cast<const float4*>(wt + kk * BN + 64 + 4 * tx);
      }
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = mad(acc[i][j], a[i], b[j]);
    }
    if ((kt + 1) % (KC / BK) == 0 || kt == ntiles - 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (TS) {
            float* p = tots + (i * 8 + j) * THREADS + t;
            *p = __fadd_rn(*p, acc[i][j]);
          } else {
            tot[i][j] = __fadd_rn(tot[i][j], acc[i][j]);
          }
          acc[i][j] = 0.f;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (TS) acc[i][j] = tots[(i * 8 + j) * THREADS + t];
      else acc[i][j] = tot[i][j];
    }
  const bool yv = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      float* out = y + (long long)m * N + n;
      if (yv && n < N) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) out[e] = acc[i][4 * h + e];
      }
    }
  }
}

template <bool TIED, bool TS>
cudaError_t launch_ts(const float* x, const float* w, float* y, int M, int N,
                      int K, long long sk, long long sn, bool xv, bool wv,
                      cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * STAGES * TILE + (TS ? 64 * THREADS : 0));
  static size_t granted[dyn_smem::MAX_DEVICES] = {};
  const cudaError_t err =
      dyn_smem::opt_in(prefill_kernel<TIED, TS>, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  prefill_kernel<TIED, TS><<<grid, THREADS, smem, st>>>(x, w, y, M, N, K, sk,
                                                        sn, xv, wv);
  return cudaGetLastError();
}

// totals in shared memory (two blocks an SM) where the tiles outnumber
// the SMs; in registers (one block, 8 warps) where they do not
template <bool TIED>
cudaError_t launch(const float* x, const float* w, float* y, int M, int N,
                   int K, long long sk, long long sn, bool xv, bool wv,
                   cudaStream_t st) {
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  if (tiles > sm_count())
    return launch_ts<TIED, true>(x, w, y, M, N, K, sk, sn, xv, wv, st);
  return launch_ts<TIED, false>(x, w, y, M, N, K, sk, sn, xv, wv, st);
}

}  // namespace prefill

}  // namespace

// y (M, N) float32 contiguous = x (M, K) float32 contiguous @ w, w's
// element (k, n) at w + k * sk + n * sn (offsets in 64 bits).  Returns
// the launch's CUDA error (0 on success).
extern "C" int rg_row_gemm(const void* x, const void* w, void* y, int M,
                           int N, int K, int sk, int sn, void* stream) {
  if (M < 0 || N < 0 || K < 0 || sk < 0 || sn < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  float* yf = (float*)y;
  const bool tied = sk == 1 && sn != 1;    // the tied head's layout
  const bool xv = K % 4 == 0 && aligned16(x);
  // 16-byte copies along w's unit-stride dim: whole vectors in range
  const bool wv = aligned16(w) && (tied ? sn % 4 == 0 && K % 4 == 0
                                        : sn == 1 && sk % 4 == 0 &&
                                              N % 4 == 0);
  cudaError_t err = cudaSuccess;
  if (N <= 64 && K > 0 &&
      router::launch(xf, wf, yf, M, N, K, sk, sn, xv, !tied && wv, st, &err))
    return (int)err;
  if (M <= 32)
    err = tied ? decode::rows<true>(xf, wf, yf, M, N, K, sk, sn, xv, wv, st)
               : decode::rows<false>(xf, wf, yf, M, N, K, sk, sn, xv, wv, st);
  else
    err = tied ? prefill::launch<true>(xf, wf, yf, M, N, K, sk, sn, xv, wv, st)
               : prefill::launch<false>(xf, wf, yf, M, N, K, sk, sn, xv, wv,
                                        st);
  return (int)err;
}
