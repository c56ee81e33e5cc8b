// Binarize + bitpack: (M, S) float -> (M, ceil(S/32)) packed 32-bit words.
//
// Replaces the Pallas TPU kernel src/repro/kernels/binarize_pack.py
// (binarize_pack -> _binarize_pack_kernel): bit j of word k is
// x[32k + j] >= threshold, and positions past S behave as the Pallas
// wrapper's -1.0 padding, i.e. their bit is (-1.0 >= threshold).
//
// Bound on this card: memory.  It reads M*S*4 bytes and writes
// M*ceil(S/32)*4; there is no arithmetic to speak of.  It runs once per
// weight, when the weight is first used, so it is off the per-step path.
//
// Design: one warp per output word.  Lane j reads x[32k + j] — 32
// neighbouring floats, one 128-byte transaction — and
// __ballot_sync(full, bit) puts lane j's bit at bit j, which is exactly
// the repository's packing order (core/packing.py).  A grid-stride loop
// over the words keeps the grid small for large weights.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void binarize_pack_kernel(const float* __restrict__ x,
                                     uint32_t* __restrict__ out, int M,
                                     int S, int Kw, float thr) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_block = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * warps_per_block;
  const long long n_words = (long long)M * Kw;
  const bool pad_bit = -1.0f >= thr;
  for (long long w = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
       w < n_words; w += stride) {       // warp-uniform: ballot is safe
    const long long row = w / Kw;
    const int col = (int)(w % Kw) * 32 + lane;
    const bool bit = col < S ? x[row * S + col] >= thr : pad_bit;
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) out[w] = word;
  }
}

}  // namespace

extern "C" int bp_binarize_pack(const void* x, void* out, int M, int S,
                                int Kw, float thr, void* stream) {
  const long long n_words = (long long)M * Kw;
  if (n_words == 0) return (int)cudaGetLastError();
  const int threads = 256;                      // 8 words in flight
  long long blocks = (n_words + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  binarize_pack_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (uint32_t*)out, M, S, Kw, thr);
  return (int)cudaGetLastError();
}
