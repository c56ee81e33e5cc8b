// Fixed-order RMSNorm and LayerNorm over the last dim of x (M, D),
// float32, with scale (D), an optional bias (D) and eps.
//
// Replaces no Pallas kernel.  It stands for the JAX package's plain jnp
// norms (src/repro/layers/common.py rmsnorm, layernorm), which XLA
// fuses as it likes.  A library row reduction splits a row's sum over
// threads by the number of rows (ATen summed a 2048-wide row in
// another order at 4 rows than at 8 on the H100), so a data rank's
// rows would not round as one rank's.  Here a row's statistics have
// one order whatever M is:
//   * one warp a row; lane l sums, ascending, the elements of the
//     4-element chunks c = l, l + 32, l + 64, ... (element 4c + e for
//     e = 0..3 in turn), from +0.0, each add rounded;
//   * then the lanes' sums by an xor butterfly (offsets 16, 8, 4, 2,
//     1: s = s + shfl_xor(s, o)); addition commutes, so every lane ends
//     with the same bits;
//   * RMSNorm: ss of x*x, var = ss / D, r = 1 / sqrt(var + eps) with
//     __fsqrt_rn and __fdiv_rn (the fast rsqrt is not correctly
//     rounded), y = (x * r) * scale;
//   * LayerNorm: mu = sum(x) / D, var = sum((x - mu)^2) / D (two
//     passes, as jnp.var), r as above, y = ((x - mu) * r) * scale
//     + bias.
// Every op is a correctly rounded float32 op, so
// kernels/rowwise.row_norm_torch repeats the order with torch ops and
// equals this bit for bit.
//
// Bound on this card: the bytes, one read of x and one write of y
// (8 D M bytes; 64 KiB for a decode row at D = 8192, 20 ns at
// 3.35 TB/s: launch latency is the real floor at decode).  Design: one
// warp a row, four rows a block of 128 threads, 16-byte loads where a
// row is 16-byte aligned; the passes re-read the row from L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;                  // warps (rows) a block

__device__ __forceinline__ float butterfly(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// The four elements of chunk c of the row (0.0 past D).
template <bool VEC>
__device__ __forceinline__ float4 chunk(const float* __restrict__ row,
                                        int c, int D) {
  if (VEC) return reinterpret_cast<const float4*>(row)[c];
  const int i = 4 * c;
  return make_float4(row[i], i + 1 < D ? row[i + 1] : 0.f,
                     i + 2 < D ? row[i + 2] : 0.f,
                     i + 3 < D ? row[i + 3] : 0.f);
}

// sum over the row of f(element) in the lanes' order (header comment);
// f(0.0) of a pad position must be +-0.0
template <bool VEC, class F>
__device__ __forceinline__ float row_sum(const float* __restrict__ row,
                                         int D, int lane, F f) {
  float s = 0.f;
  const int chunks = (D + 3) / 4;
#pragma unroll 4
  for (int c = lane; c < chunks; c += 32) {
    const float4 v = chunk<VEC>(row, c, D);
    s = __fadd_rn(s, f(v.x));
    s = __fadd_rn(s, f(v.y));
    s = __fadd_rn(s, f(v.z));
    s = __fadd_rn(s, f(v.w));
  }
  return butterfly(s);
}

template <bool VEC>
__global__ void __launch_bounds__(32 * ROWS)
row_norm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ y, int M,
                int D, float eps, bool layer) {
  const int m = blockIdx.x * ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const float* row = x + (long long)m * D;
  float* out = y + (long long)m * D;
  const float d = (float)D;
  float mu = 0.f, var;
  if (layer) {
    mu = __fdiv_rn(row_sum<VEC>(row, D, lane, [](float v) { return v; }), d);
    // a pad position adds 0.0, not (0 - mu)^2: real elements only
    float s = 0.f;
    const int chunks = (D + 3) / 4;
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) {
      const float4 v = chunk<VEC>(row, c, D);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = 4 * c + j < D ? __fsub_rn(e[j], mu) : 0.f;
        s = __fadd_rn(s, __fmul_rn(t, t));
      }
    }
    var = __fdiv_rn(butterfly(s), d);
  } else {
    var = __fdiv_rn(
        row_sum<VEC>(row, D, lane, [](float v) { return __fmul_rn(v, v); }),
        d);
  }
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int i = lane; i < D; i += 32) {
    float v = layer ? __fsub_rn(row[i], mu) : row[i];
    v = __fmul_rn(__fmul_rn(v, r), scale[i]);
    if (bias != nullptr) v = __fadd_rn(v, bias[i]);
    out[i] = v;
  }
}

}  // namespace

// y (M, D) = the norm of x (M, D), both float32 contiguous; scale (D),
// bias (D) or null; layer: 0 RMSNorm, 1 LayerNorm.  Returns
// cudaGetLastError().
extern "C" int rn_row_norm(const void* x, const void* scale,
                           const void* bias, void* y, int M, int D,
                           float eps, int layer, void* stream) {
  if (M < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  const dim3 grid((M + ROWS - 1) / ROWS);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  if (D % 4 == 0 && (uintptr_t)x % 16 == 0)
    row_norm_kernel<true><<<grid, 32 * ROWS, 0, st>>>(
        xf, (const float*)scale, (const float*)bias, (float*)y, M, D, eps,
        layer != 0);
  else
    row_norm_kernel<false><<<grid, 32 * ROWS, 0, st>>>(
        xf, (const float*)scale, (const float*)bias, (float*)y, M, D, eps,
        layer != 0);
  return (int)cudaGetLastError();
}
