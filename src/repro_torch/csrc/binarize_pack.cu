// Binarize + bitpack: (M, S) float -> (M, ceil(S/32)) packed 32-bit words,
// and the same of a convolution's patch matrix read straight from its
// NHWC input (an implicit im2col).
//
// Replaces the Pallas TPU kernel src/repro/kernels/binarize_pack.py
// (binarize_pack -> _binarize_pack_kernel): bit j of word k is
// x[32k + j] >= threshold, and positions past S behave as the Pallas
// wrapper's -1.0 padding, i.e. their bit is (-1.0 >= threshold).  The
// patch entry packs the rows of core/conv's im2col (patch order (kh, kw,
// C), JAX's SAME or VALID padding) without writing them: a tap that
// falls in the spatial padding is the pad's 0.0, so its bit is
// (0.0 >= threshold), while a position past S is still (-1.0 >= thr).
//
// Bound on this card: memory.  The matrix entry reads M*S*4 bytes and
// writes M*ceil(S/32)*4; the patch entry reads the input once (its taps
// overlap, the re-reads hit L2) and writes the words.  There is no
// arithmetic to speak of.
//
// Design: 8 lanes build one word, each from 4 neighbouring elements (one
// 16-byte load where the rows allow it: S, or C for the patches, a
// multiple of 4), their 4 bits shifted into place and OR-ed across the 8
// lanes by three shuffles, so a warp packs 4 words a step and keeps
// UNROLL steps of loads in flight before it uses any.  The grid is sized
// from the SM count (at most BLOCKS_PER_SM blocks an SM) and strides over
// the words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                   // warp steps of loads in flight
constexpr int WORDS_PER_STEP = THREADS / 8;  // words a block packs a step
constexpr int BLOCKS_PER_SM = 8;

// The 4 bits of x[0..3] at their place in the lane's word, OR-ed with
// the other 7 lanes of its group: every lane of the group returns the
// word.  All 32 lanes call it.
__device__ __forceinline__ uint32_t word_of(uint32_t bits4, int lig) {
  uint32_t w = bits4 << (4 * lig);
  w |= __shfl_xor_sync(0xffffffffu, w, 1);
  w |= __shfl_xor_sync(0xffffffffu, w, 2);
  w |= __shfl_xor_sync(0xffffffffu, w, 4);
  return w;
}

__device__ __forceinline__ uint32_t bits_of(float4 v, float thr) {
  return (uint32_t)(v.x >= thr) | (uint32_t)(v.y >= thr) << 1 |
         (uint32_t)(v.z >= thr) << 2 | (uint32_t)(v.w >= thr) << 3;
}

// (M, S) rows.  VEC: S % 4 == 0 and x 16-byte aligned, so a lane's 4
// elements are one float4, all inside S or all past it.
template <bool VEC>
__global__ __launch_bounds__(THREADS) void binarize_pack_kernel(
    const float* __restrict__ x, uint32_t* __restrict__ out, int n_words,
    int S, int Kw, float thr) {
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 3, lig = lane & 7;
  const uint32_t pad4 = -1.0f >= thr ? 0xfu : 0u;
  for (int w0 = blockIdx.x * WORDS_PER_STEP * UNROLL; w0 < n_words;
       w0 += gridDim.x * WORDS_PER_STEP * UNROLL) {   // block-uniform
    float4 v[UNROLL];
    int col[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int w = w0 + u * WORDS_PER_STEP + grp;
      v[u] = make_float4(-1.f, -1.f, -1.f, -1.f);
      col[u] = S;                                 // past S: pad bits
      if (w < n_words) {
        const int row = w / Kw;
        col[u] = 32 * (w - row * Kw) + 4 * lig;
        const float* src = x + (size_t)row * S + col[u];
        if (VEC) {
          if (col[u] < S) v[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (col[u] < S) v[u].x = __ldg(src);
          if (col[u] + 1 < S) v[u].y = __ldg(src + 1);
          if (col[u] + 2 < S) v[u].z = __ldg(src + 2);
          if (col[u] + 3 < S) v[u].w = __ldg(src + 3);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      uint32_t b = bits_of(v[u], thr);
      const int n_in = min(max(S - col[u], 0), 4);  // elements inside S
      b = (b & ((1u << n_in) - 1u)) | (pad4 & ~((1u << n_in) - 1u));
      const uint32_t word = word_of(b, lig);
      const int w = w0 + u * WORDS_PER_STEP + grp;
      if (lig == 0 && w < n_words) out[w] = word;
    }
  }
}

// Patch rows of an NHWC input (B, H, W, C): row (b, oy, ox) of
// B * Ho * Wo, element e = (i * kw + j) * C + c of S = kh * kw * C is
// x[b, oy * stride - pt + i, ox * stride - pl + j, c], or 0.0 where that
// falls outside the image.  VEC: C % 4 == 0 and x 16-byte aligned, so a
// lane's 4 elements are one float4 of one tap.
template <bool VEC>
__global__ __launch_bounds__(THREADS) void pack_patches_kernel(
    const float* __restrict__ x, uint32_t* __restrict__ out, int n_words,
    int S, int Kw, int H, int W, int C, int kw, int stride, int pt, int pl,
    int Ho, int Wo, float thr) {
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 3, lig = lane & 7;
  const uint32_t pad4 = -1.0f >= thr ? 0xfu : 0u;
  for (int w0 = blockIdx.x * WORDS_PER_STEP * UNROLL; w0 < n_words;
       w0 += gridDim.x * WORDS_PER_STEP * UNROLL) {   // block-uniform
    float4 v[UNROLL];
    int col[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int w = w0 + u * WORDS_PER_STEP + grp;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      col[u] = S;                                 // past S: pad bits
      if (w < n_words) {
        const int row = w / Kw;
        col[u] = 32 * (w - row * Kw) + 4 * lig;
        const int t = row / Wo, ox = row - t * Wo;
        const int b = t / Ho, oy = t - b * Ho;
        const float* xb = x + (size_t)b * H * W * C;
        const int y0 = oy * stride - pt, x0 = ox * stride - pl;
        // element e = (i * kw + j) * C + c of the lane's first element;
        // the next ones step c, then j, then i
        int tap = col[u] / C, c = col[u] - tap * C;
        int i = tap / kw, j = tap - i * kw;
        float e4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < (VEC ? 1 : 4); ++k) {
          const int y = y0 + i, xx = x0 + j;
          if (col[u] + k < S && y >= 0 && y < H && xx >= 0 && xx < W) {
            const float* src = xb + ((size_t)y * W + xx) * C + c;
            if (VEC)
              v[u] = __ldg(reinterpret_cast<const float4*>(src));
            else
              e4[k] = __ldg(src);
          }                                     // else the pad's 0.0
          if (++c == C) {
            c = 0;
            if (++j == kw) {
              j = 0;
              ++i;
            }
          }
        }
        if (!VEC) v[u] = make_float4(e4[0], e4[1], e4[2], e4[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      uint32_t b = bits_of(v[u], thr);
      const int n_in = min(max(S - col[u], 0), 4);  // elements inside S
      b = (b & ((1u << n_in) - 1u)) | (pad4 & ~((1u << n_in) - 1u));
      const uint32_t word = word_of(b, lig);
      const int w = w0 + u * WORDS_PER_STEP + grp;
      if (lig == 0 && w < n_words) out[w] = word;
    }
  }
}

int grid_for(long long n_words, int sms) {
  const long long per_block = (long long)WORDS_PER_STEP * UNROLL;
  const long long want = (n_words + per_block - 1) / per_block;
  const long long cap = (long long)(sms > 0 ? sms : 1) * BLOCKS_PER_SM;
  return (int)(want < cap ? want : cap);
}

}  // namespace

extern "C" int bp_binarize_pack(const void* x, void* out, int M, int S,
                                int Kw, float thr, int sms, void* stream) {
  const long long n_words = (long long)M * Kw;
  if (n_words == 0) return (int)cudaGetLastError();
  if (n_words > 0x7fffffffLL || S <= 0 || Kw < (S + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_for(n_words, sms));
  const cudaStream_t st = (cudaStream_t)stream;
  if (S % 4 == 0 && (uintptr_t)x % 16 == 0)
    binarize_pack_kernel<true><<<grid, THREADS, 0, st>>>(
        (const float*)x, (uint32_t*)out, (int)n_words, S, Kw, thr);
  else
    binarize_pack_kernel<false><<<grid, THREADS, 0, st>>>(
        (const float*)x, (uint32_t*)out, (int)n_words, S, Kw, thr);
  return (int)cudaGetLastError();
}

// x (B, H, W, C) float32 contiguous; out (B * Ho * Wo, Kw) words with
// Kw = ceil(kh * kw * C / 32); pt, pl the top and left padding (JAX's
// SAME split, or 0 for VALID); Ho, Wo the output size.
extern "C" int bp_pack_patches(const void* x, void* out, int B, int H,
                               int W, int C, int kh, int kw, int stride,
                               int pt, int pl, int Ho, int Wo, int Kw,
                               float thr, int sms, void* stream) {
  const long long S = (long long)kh * kw * C;
  const long long n_words = (long long)B * Ho * Wo * Kw;
  if (n_words == 0) return (int)cudaGetLastError();
  if (n_words > 0x7fffffffLL || S <= 0 || S > 0x7fffffffLL ||
      Kw != (S + 31) / 32 || stride <= 0 || pt < 0 || pl < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_for(n_words, sms));
  const cudaStream_t st = (cudaStream_t)stream;
  if (C % 4 == 0 && (uintptr_t)x % 16 == 0)
    pack_patches_kernel<true><<<grid, THREADS, 0, st>>>(
        (const float*)x, (uint32_t*)out, (int)n_words, (int)S, Kw, H, W, C,
        kw, stride, pt, pl, Ho, Wo, thr);
  else
    pack_patches_kernel<false><<<grid, THREADS, 0, st>>>(
        (const float*)x, (uint32_t*)out, (int)n_words, (int)S, Kw, H, W, C,
        kw, stride, pt, pl, Ho, Wo, thr);
  return (int)cudaGetLastError();
}
