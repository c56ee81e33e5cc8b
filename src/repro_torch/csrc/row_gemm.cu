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
// be one rank's.  Here every y[m][n] is
//     acc = +0.0;  for k = 0 .. K-1 ascending:
//         acc = __fadd_rn(acc, __fmul_rn(x[m][k], w[k][n]));
// each product rounded, then each add (nvcc would contract a*b+c into
// an FMA by default), so its bits depend on row m of x and column n of
// w alone: not on M, N, which columns of a larger w these are, the grid
// or the tile.  A tile's k positions past K hold zeros on both sides;
// acc is never -0.0 (it starts at +0.0, and a sum is -0.0 only when
// both terms are), so adding their +-0.0 products leaves it unchanged.
// kernels/rowwise.row_gemm_torch repeats the order with torch ops and
// equals this bit for bit.
//
// w is read through its strides (sk, sn), so the tied head, the
// embedding's transposed view (sk = 1, sn = d), needs no copy: each
// tile load maps consecutive threads onto the unit-stride dim.
//
// Bound on this card.  At decode (M <= 8) a read of w: mixtral's
// 4096 x 32000 head is 524 MB, 156 us at 3.35 TB/s.  At M = 128 the
// 2 M N K operations: 33.5 G for mixtral's head, 0.50 ms at the
// float32 data-sheet rate, which counts an FMA as two; separate
// products and adds issue twice the instructions, so 1.0 ms is this
// design's floor there.
//
// Design.  A simple tiled SIMT kernel: a block stages a BK-deep tile of
// x and of w in shared memory, each thread keeps TM x TN sums in
// registers (rows ty + i * BM / TM, columns tx + j * BN / TN: a warp
// reads consecutive columns of the w tile), and the next tile's loads
// are issued into registers before the current tile is summed.  Three
// shapes: a head at M <= 8 takes all the rows in one block row (TM =
// BM = 1, 2, 4 or 8, BN = 128, 128 threads, BK = 32: each thread has
// 32 loads of w in flight); larger M 64 x 64 tiles of 4 x 4 a thread; a
// router (N <= 64: one column tile, so few blocks, each a long chain
// over K) deep tiles (BK = 256 for N <= 32, 128 for N <= 64) of up to
// 8 rows, a thread a (row, column) and at least 256 threads loading
// (the rest only load), so that few tiles' load latencies line up.  No split over K: a split would
// change the order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// LF: load factor; the block has LF times the threads that sum, and
// all of them load the tiles (the routers' few columns want more loads
// in flight than summing threads)
template <int BM, int BN, int BK, int TM, int TN, int LF>
__global__ void __launch_bounds__((BM / TM) * (BN / TN) * LF)
row_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, int M, int N, int K, long long sk,
                long long sn) {
  constexpr int TX = BN / TN, TY = BM / TM, SUMMERS = TX * TY;
  constexpr int THREADS = SUMMERS * LF;
  static_assert((BK * BN) % THREADS == 0,
                "the w tile's loads must divide among the threads");
  constexpr int WPT = BK * BN / THREADS;                  // w loads a thread
  constexpr int XPT = (BM * BK + THREADS - 1) / THREADS;  // x loads a thread
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool k_unit = sk == 1 && sn != 1;   // the tied head's layout
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // the next tile in registers: its loads are in flight while the
  // current tile is summed
  float xv[XPT], wv[WPT];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < XPT; ++r) {   // consecutive threads: consecutive k
      const int e = t + r * THREADS;
      const int m = m0 + e / BK, k = k0 + e % BK;
      xv[r] = (e < BM * BK && m < M && k < K) ? x[(long long)m * K + k]
                                             : 0.f;
    }
#pragma unroll
    for (int r = 0; r < WPT; ++r) {   // ... and on the unit-stride dim
      const int e = t + r * THREADS;
      const int k = k0 + (k_unit ? e % BK : e / BN);
      const int n = n0 + (k_unit ? e / BK : e % BN);
      wv[r] = (k < K && n < N) ? w[k * sk + n * sn] : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int r = 0; r < XPT; ++r) {
      const int e = t + r * THREADS;
      if (e < BM * BK) xs[e % BK][e / BK] = xv[r];
    }
#pragma unroll
    for (int r = 0; r < WPT; ++r) {
      const int e = t + r * THREADS;
      ws[k_unit ? e % BK : e / BN][k_unit ? e / BK : e % BN] = wv[r];
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);
    if (t < SUMMERS) {                  // the others only load
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
      }
    }
    __syncthreads();
  }
  if (t >= SUMMERS) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) y[(long long)m * N + n] = acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN, int LF = 1>
void launch(const float* x, const float* w, float* y, int M, int N, int K,
            long long sk, long long sn, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  row_gemm_kernel<BM, BN, BK, TM, TN, LF>
      <<<grid, (BM / TM) * (BN / TN) * LF, 0, st>>>(x, w, y, M, N, K, sk,
                                                     sn);
}

// a router (N <= 64): up to 8 rows a block, a thread a (row, column),
// and at least 256 threads loading deep tiles (extra loaders where the
// rows are fewer: LF)
template <int BN, int BK>
void launch_router(const float* x, const float* w, float* y, int M, int N,
                   int K, long long sk, long long sn, cudaStream_t st) {
  constexpr int LF1 = 256 / BN;
  constexpr int LF2 = LF1 / 2 > 1 ? LF1 / 2 : 1;
  constexpr int LF4 = LF1 / 4 > 1 ? LF1 / 4 : 1;
  if (M == 1)
    launch<1, BN, BK, 1, 1, LF1>(x, w, y, M, N, K, sk, sn, st);
  else if (M == 2)
    launch<2, BN, BK, 1, 1, LF2>(x, w, y, M, N, K, sk, sn, st);
  else if (M <= 4)
    launch<4, BN, BK, 1, 1, LF4>(x, w, y, M, N, K, sk, sn, st);
  else
    launch<8, BN, BK, 1, 1, 1>(x, w, y, M, N, K, sk, sn, st);
}

}  // namespace

// y (M, N) float32 contiguous = x (M, K) float32 contiguous @ w, w's
// element (k, n) at w + k * sk + n * sn (offsets in 64 bits).  Returns
// cudaGetLastError().
extern "C" int rg_row_gemm(const void* x, const void* w, void* y, int M,
                           int N, int K, int sk, int sn, void* stream) {
  if (M < 0 || N < 0 || K < 0 || sk < 0 || sn < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if ((M + 7) / 8 > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  float* yf = (float*)y;
  if (N <= 32)            // a router of 8 or 16 experts
    launch_router<32, 256>(xf, wf, yf, M, N, K, sk, sn, st);
  else if (N <= 64)       // a router of 64 experts
    launch_router<64, 128>(xf, wf, yf, M, N, K, sk, sn, st);
  else if (M == 1)
    launch<1, 128, 32, 1, 1>(xf, wf, yf, M, N, K, sk, sn, st);
  else if (M == 2)
    launch<2, 128, 32, 2, 1>(xf, wf, yf, M, N, K, sk, sn, st);
  else if (M <= 4)
    launch<4, 128, 32, 4, 1>(xf, wf, yf, M, N, K, sk, sn, st);
  else if (M <= 8)
    launch<8, 128, 32, 8, 1>(xf, wf, yf, M, N, K, sk, sn, st);
  else
    launch<64, 64, 16, 4, 4>(xf, wf, yf, M, N, K, sk, sn, st);
  return (int)cudaGetLastError();
}
