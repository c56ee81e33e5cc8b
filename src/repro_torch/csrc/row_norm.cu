// Fixed-order RMSNorm and LayerNorm over the last dim of x (M, D),
// float32, with scale (D), an optional bias (D) and eps.
//
// Replaces no Pallas kernel.  It stands for the JAX package's plain jnp
// norms (src/repro/layers/common.py rmsnorm, layernorm), which XLA
// fuses as it likes.  A library row reduction splits a row's sum over
// threads by the number of rows (ATen summed a 2048-wide row in
// another order at 4 rows than at 8 on the H100), so a data rank's
// rows would not round as one rank's.  Here a row's statistics have
// one order, set by D alone, whatever M is:
//   * the row has 32 W lanes, W = warps(D) = min(8, ceil(D / 1024));
//     lane l sums, ascending, the elements of the 4-element chunks
//     c = l, l + 32 W, l + 64 W, ... (element 4c + e for e = 0..3 in
//     turn), from +0.0, each add rounded;
//   * each warp's 32 lane sums by an xor butterfly (offsets 16, 8, 4,
//     2, 1: s = s + shfl_xor(s, o)); addition commutes, so every lane
//     of the warp ends with the same bits, the warp's total;
//   * the W warp totals added in ascending warp order from +0.0 (for
//     W = 1 the one total itself: +0.0 + t = t, as t is never -0.0);
//   * RMSNorm: ss of x*x, var = ss / D, r = 1 / sqrt(var + eps) with
//     __fsqrt_rn and __fdiv_rn (the fast rsqrt is not correctly
//     rounded), y = (x * r) * scale;
//   * LayerNorm: mu = sum(x) / D, var = sum((x - mu)^2) / D (two
//     passes, as jnp.var), r as above, y = ((x - mu) * r) * scale
//     + bias.
// For D <= 1024 (W = 1) this is the one-warp order the kernel had
// before wider rows got a block: bnn-lm-100m's and the reduced
// configs' bits did not move.  Every op is a correctly rounded float32
// op, so kernels/rowwise.row_norm_torch repeats the order with torch
// ops and equals this bit for bit.
//
// Bound on this card: the bytes, one read of x and one write of y
// (8 D M bytes; 64 KiB for a decode row at D = 8192, 20 ns at
// 3.35 TB/s), so at the serving paths' M (1 to a few hundred rows) the
// floor is launch latency plus one round trip to memory.  Design: a
// row's lanes load all of its chunks, and the scale's (and bias's),
// into registers before the first add, 16 bytes a load where the rows
// are 16-byte aligned, so x is read from device memory once for
// RMSNorm and for both LayerNorm passes and the whole row costs one
// round trip.  D <= 1024: one warp a row, four rows a block of 128
// threads.  Wider rows: one block of 32 W threads a row (W warps, so
// at D = 8192 a lane holds 8 chunks, not 64), the warp totals
// combined through shared memory in the fixed warp order.  A row wider
// than a lane's registers hold (D > 16384) is read again from L1/L2 in
// each pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE_SPAN = 1024;          // elements a warp of a row covers
constexpr int MAX_WARPS = 8;             // warps(D) = min(8, ceil(D / 1024))
constexpr int ROWS = 4;                  // rows a block at W = 1

inline int warps(int d) {
  const int w = (d + LANE_SPAN - 1) / LANE_SPAN;
  return w < MAX_WARPS ? w : MAX_WARPS;
}

__device__ __forceinline__ float butterfly(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// The four elements of chunk c of a row (0.0 past D).
template <bool VEC>
__device__ __forceinline__ float4 chunk(const float* __restrict__ row,
                                        int c, int D) {
  if (VEC) return reinterpret_cast<const float4*>(row)[c];
  const int i = 4 * c;
  return make_float4(row[i], i + 1 < D ? row[i + 1] : 0.f,
                     i + 2 < D ? row[i + 2] : 0.f,
                     i + 3 < D ? row[i + 3] : 0.f);
}

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// W warps a row (W = 1: ROWS rows a block, a warp each).  CPL: chunks
// a lane holds in registers (the row's chunks, scale's and bias's are
// loaded once); CPL = 0: none held, each pass reads the row again.
template <int W, int CPL, bool VEC>
__global__ void __launch_bounds__(W == 1 ? 32 * ROWS : 32 * W)
row_norm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ y, int M,
                int D, float eps, bool layer) {
  constexpr int L = 32 * W;                           // lanes a row
  constexpr bool HOLD_AFFINE = CPL > 0 && CPL <= 8;   // scale, bias too
  constexpr int HX = CPL > 0 ? CPL : 1;
  constexpr int HA = HOLD_AFFINE ? CPL : 1;
  __shared__ float warp_tot[2][W];
  const int m = W == 1 ? blockIdx.x * ROWS + threadIdx.x / 32 : blockIdx.x;
  const int lane = W == 1 ? threadIdx.x % 32 : threadIdx.x;
  if (m >= M) return;       // W > 1: a block's threads share one row
  const float* row = x + (long long)m * D;
  float* out = y + (long long)m * D;
  const int chunks = (D + 3) / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 v[HX], sc[HA], bi[HA];
  if constexpr (CPL > 0) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + j * L;
      v[j] = c < chunks ? chunk<VEC>(row, c, D) : zero;
      if constexpr (HOLD_AFFINE) {
        sc[j] = c < chunks ? chunk<VEC>(scale, c, D) : zero;
        bi[j] = c < chunks && bias != nullptr ? chunk<VEC>(bias, c, D)
                                              : zero;
      }
    }
  }
  // f(c, q) for the lane's chunks c in ascending order, q the chunk
  auto visit = [&](auto f) {
    if constexpr (CPL > 0) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + j * L;
        if (c < chunks) f(j, c, v[j]);
      }
    } else {
      for (int c = lane; c < chunks; c += L) f(0, c, chunk<VEC>(row, c, D));
    }
  };
  // the row's sum of g(element, its index) in the fixed order; every
  // thread of the row returns it.  g of a pad position must be +-0.0.
  auto row_sum = [&](int pass, auto g) {
    float s = 0.f;
    visit([&](int, int c, float4 q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s = __fadd_rn(s, g(elem(q, e), 4 * c + e));
    });
    s = butterfly(s);
    if constexpr (W > 1) {
      if (lane % 32 == 0) warp_tot[pass][lane / 32] = s;
      __syncthreads();
      s = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) s = __fadd_rn(s, warp_tot[pass][w]);
    }
    return s;
  };
  const float d = (float)D;
  float mu = 0.f, var;
  if (layer) {
    mu = __fdiv_rn(row_sum(0, [](float a, int) { return a; }), d);
    // a pad position adds 0.0, not (0 - mu)^2: real elements only
    var = __fdiv_rn(row_sum(1, [&](float a, int i) {
                      const float t = i < D ? __fsub_rn(a, mu) : 0.f;
                      return __fmul_rn(t, t);
                    }), d);
  } else {
    var = __fdiv_rn(row_sum(0, [](float a, int) { return __fmul_rn(a, a); }),
                    d);
  }
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  visit([&](int j, int c, float4 q) {
    float4 s, b;
    if constexpr (HOLD_AFFINE) {
      s = sc[j];
      b = bi[j];
    } else {
      s = chunk<VEC>(scale, c, D);
      b = bias != nullptr ? chunk<VEC>(bias, c, D) : zero;
    }
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float t = layer ? __fsub_rn(elem(q, e), mu) : elem(q, e);
      t = __fmul_rn(__fmul_rn(t, r), elem(s, e));
      o[e] = bias != nullptr ? __fadd_rn(t, elem(b, e)) : t;
    }
    if (VEC) {
      reinterpret_cast<float4*>(out)[c] = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c + e < D) out[4 * c + e] = o[e];
    }
  });
}

template <int W, int CPL>
void launch(bool vec, const float* x, const float* scale, const float* bias,
            float* y, int M, int D, float eps, bool layer, cudaStream_t st) {
  const dim3 grid(W == 1 ? (M + ROWS - 1) / ROWS : M);
  const int threads = W == 1 ? 32 * ROWS : 32 * W;
  if (vec)
    row_norm_kernel<W, CPL, true>
        <<<grid, threads, 0, st>>>(x, scale, bias, y, M, D, eps, layer);
  else
    row_norm_kernel<W, CPL, false>
        <<<grid, threads, 0, st>>>(x, scale, bias, y, M, D, eps, layer);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// y (M, D) = the norm of x (M, D), both float32 contiguous; scale (D),
// bias (D) or null; layer: 0 RMSNorm, 1 LayerNorm.  Returns
// cudaGetLastError().
extern "C" int rn_row_norm(const void* x, const void* scale,
                           const void* bias, void* y, int M, int D,
                           float eps, int layer, void* stream) {
  if (M < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* sf = (const float*)scale;
  const float* bf = (const float*)bias;
  float* yf = (float*)y;
  const bool vec = D % 4 == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(scale) && (bias == nullptr || aligned16(bias));
  const bool ln = layer != 0;
  const int per_lane = ((D + 3) / 4 + 32 * warps(D) - 1) / (32 * warps(D));
  switch (warps(D)) {
    case 1: launch<1, 8>(vec, xf, sf, bf, yf, M, D, eps, ln, st); break;
    case 2: launch<2, 8>(vec, xf, sf, bf, yf, M, D, eps, ln, st); break;
    case 3: launch<3, 8>(vec, xf, sf, bf, yf, M, D, eps, ln, st); break;
    case 4: launch<4, 8>(vec, xf, sf, bf, yf, M, D, eps, ln, st); break;
    case 5: launch<5, 8>(vec, xf, sf, bf, yf, M, D, eps, ln, st); break;
    case 6: launch<6, 8>(vec, xf, sf, bf, yf, M, D, eps, ln, st); break;
    case 7: launch<7, 8>(vec, xf, sf, bf, yf, M, D, eps, ln, st); break;
    default:
      if (per_lane <= 8)
        launch<8, 8>(vec, xf, sf, bf, yf, M, D, eps, ln, st);
      else if (per_lane <= 16)
        launch<8, 16>(vec, xf, sf, bf, yf, M, D, eps, ln, st);
      else
        launch<8, 0>(vec, xf, sf, bf, yf, M, D, eps, ln, st);
  }
  return (int)cudaGetLastError();
}
