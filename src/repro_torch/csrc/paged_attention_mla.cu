// Paged MLA attention: walk each row's block table over the COMPRESSED
// latent pools (c_kv, k_rope) with an online softmax, causal and window
// masks, per-row kv_len and q_offset, on a paged table or a
// sliding-window ring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention -> _paged_attn_kernel) in its layout="mla" variant,
// ring=False and ring=True.  Shapes: q (B, C, H, nope + Dr); pools
// c_kv (NB, BS, R) and k_rope (NB, BS, Dr); k_up (R, H*nope); v_up
// (R, H*Dv); block_table (B, MB); kv_len, q_offset, newest (B,); out
// (B, C, H, Dv); all float32 / int32.  Semantics as the Pallas body:
// with K_nope[s, h] = c_kv[s] . k_up[:, h] and V[s, h] = c_kv[s] . v_up[:, h],
// score = scale * (q_nope[h] . K_nope[s, h] + q_rope[h] . k_rope[s]),
// scale = (nope + Dr)^-0.5; slot positions, masks, the -1e30 fill, zero
// weights of masked keys and zero rows as in paged_attention.cu.
//
// Bound on this card: at decode, memory — the latents the walk reads,
// kv_len * (R + Dr) * 4 bytes per batch row, plus k_up and v_up
// (2 * R * H * 128 * 4 = 8 MB at DeepSeek-V2-Lite's widths); at prefill
// the operations of the absorbed form below, 2 (R + Dr) + 2 R per
// visible (query row, key) pair, on tensor cores in 3xTF32 (three TF32
// products per float32 product: 495 / 3 TFLOP/s of float32 work).
//
// Design: the TPU kept k_up and v_up resident in VMEM and decompressed
// every gathered block per head.  Here the two 4 MB matrices cannot sit
// in a block's 227 KB of shared memory, so the kernel computes the same
// function in the absorbed order, in three or four launches on one
// stream:
//   1. q_lat[b, c, h, :] = scale * q_nope[b, c, h] . k_up[:, h]^T  (R wide)
//      — a batched GEMM, one batch per head (tf32x3_gemm_kernel);
//   2. the walk, with an online softmax over an R-wide accumulator of
//      the weighted LATENTS per query row; skipped are blocks no query of
//      the tile can see (kv_len, causal, window, never-written ring
//      slots).  Two paths, chosen by the wrapper:
//      * decode (C * H <= 16 query rows per batch row, or widths other
//        than R = 512, Dr = 64): mla_walk_kernel.  A block owns RT = 16
//        query rows (c, h) of one batch row and one part of its table
//        (the walk is split into `nsplit` parts when B * tiles would
//        leave the card idle).  It stages each latent block (BS x
//        (R + Dr) floats; 16-byte loads) in shared memory ONCE for all
//        16 rows, scores q_lat . c_kv + q_rope . k_rope on CUDA cores,
//        and writes its part's (acc, m, l); then
//   3.   merge the parts' (m, l, acc) and divide by l;
//      * prefill (tiled, more query rows): mla_tiled_kernel, described
//        at it; it writes the normalised accumulator itself (no launch
//        3);
//   4. out[b, c, h, :] = acc[b, c, h] . v_up[:, h]  — the batched GEMM
//      again.
// The GEMMs and the tiled walk multiply on tensor cores in 3xTF32:
// each float32 operand x splits into hi = x rounded to the nearest TF32
// value and lo = x - hi rounded the same way; hi.hi + hi.lo + lo.hi is
// the product to about 3 * 2^-22 of |x y|, against 2^-11 for one TF32
// product.  Each 8-deep step's products are summed on the tensor core
// from zero and added to the running float32 sum outside it (mma3): the
// tensor core's own sums truncate, and chained over a 576-long dot they
// left the tiled walk several times further from the plain version than
// the float32 decode walk, enough to flip sign bits of the o
// projection's input between a request's decode and a prefill of it.
// The decode walk's arithmetic is float32 on the CUDA cores.  The
// summation order differs from decompress-then-dot.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int RT = 16;            // query rows (c, h) per walk block
constexpr int WALK_THREADS = 256;
constexpr int GT = 64;            // GEMM output tile (GT x GT)
constexpr int GK = 32;            // GEMM K tile
constexpr int GLD = GK + 8;       // its smem row stride: rows g = 0..3 of a
                                  // fragment's 8-byte loads on distinct banks
constexpr int GTHREADS = 128;     // 4 warps of 32 x 32
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------ 3xTF32

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// x rounded to the nearest TF32 value (10 mantissa bits; ties away from
// zero): add half a TF32 unit to the magnitude, clear the low 13 bits.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + e, hi and lo TF32 values, |lo| <= 2^-11 |x| and
// |e| <= 2^-22 |x|: the 3xTF32 product below is x y to about 3 * 2^-22.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// d += a . b over one m16n8k8 fragment, TF32 inputs, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: acc += a_lo b_hi + a_hi b_lo + a_hi b_hi (small terms first).
// The tensor core's float32 sums truncate, so a long chain of mma into
// one accumulator drifts; each 8-deep step starts from zero instead and
// joins the running sum by a float32 add, which rounds.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// The A fragment of rows (r, r + 8) from a float2 of each: the k axis of
// every 8-wide step is permuted so that a thread's two k values (t and
// t + 4 in the mma's order) are neighbours 2t, 2t + 1 in memory, one
// 8-byte load; B takes the same permutation, so the dot is unchanged.
__device__ __forceinline__ void split_a(float2 x0, float2 x1, uint32_t (&h)[4],
                                        uint32_t (&l)[4]) {
  split_tf32(x0.x, h[0], l[0]);
  split_tf32(x1.x, h[1], l[1]);
  split_tf32(x0.y, h[2], l[2]);
  split_tf32(x1.y, h[3], l[3]);
}

// Element strides of a batched GEMM C[z] = alpha * A[z] B[z].
struct Strides {
  long long a_z, a_m, a_k, b_z, b_k, b_n, c_z, c_m, c_n;
};

// One GT x GT tile of C[z] per block of 4 warps (32 x 32 each: 2 x 4
// m16n8k8 fragments), K in GK-deep tiles staged in shared memory as
// [row][k] for both operands.  A is k-contiguous (a_k == 1) and copied
// 16 bytes at a time by cp.async; B either k-contiguous (b_k == 1,
// copied the same way) or n-contiguous (b_n == 1, read 16 bytes along n
// and transposed on the store).  K, the row strides and the pointers
// are multiples of 4 floats; M and N edges are guarded.
__global__ __launch_bounds__(GTHREADS) void tf32x3_gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    float* __restrict__ Cm, int M, int N, int K, Strides st, float alpha) {
  __shared__ __align__(16) float As[GT][GLD];
  __shared__ __align__(16) float Bs[GT][GLD];
  const int z = blockIdx.z, tid = threadIdx.x;
  const int m0 = blockIdx.y * GT, n0 = blockIdx.x * GT;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const float* a = A + z * st.a_z;
  const float* bm = Bm + z * st.b_z;
  float acc[2][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += GK) {
    for (int e = tid; e < GT * GK / 4; e += GTHREADS) {
      const int r = e / (GK / 4), kq = 4 * (e % (GK / 4));
      const int m = m0 + r, k = k0 + kq;
      const bool ok = m < M && k < K;
      cp_async16(&As[r][kq], ok ? a + m * st.a_m + k : a, ok ? 16 : 0);
    }
    if (st.b_k == 1) {
      for (int e = tid; e < GT * GK / 4; e += GTHREADS) {
        const int r = e / (GK / 4), kq = 4 * (e % (GK / 4));
        const int n = n0 + r, k = k0 + kq;
        const bool ok = n < N && k < K;
        cp_async16(&Bs[r][kq], ok ? bm + n * st.b_n + k : bm, ok ? 16 : 0);
      }
    } else {
      // a warp reads one 4-column group of 32 k rows: its stores hit
      // 32 consecutive words of each Bs row
      for (int e = tid; e < GT * GK / 4; e += GTHREADS) {
        const int nq = 4 * (e / GK), kk = e % GK;
        const int n = n0 + nq, k = k0 + kk;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < N && k < K)
          v = *reinterpret_cast<const float4*>(bm + k * st.b_k + n);
        Bs[nq][kk] = v.x;
        Bs[nq + 1][kk] = v.y;
        Bs[nq + 2][kk] = v.z;
        Bs[nq + 3][kk] = v.w;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
#pragma unroll
    for (int k8 = 0; k8 < GK; k8 += 8) {
      const int kk = k8 + 2 * t;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
        split_a(*reinterpret_cast<const float2*>(&As[wm + 16 * mf + g][kk]),
                *reinterpret_cast<const float2*>(&As[wm + 16 * mf + 8 + g][kk]),
                ah[mf], al[mf]);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const float2 y =
            *reinterpret_cast<const float2*>(&Bs[wn + 8 * nf + g][kk]);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(y.x, bh0, bl0);
        split_tf32(y.y, bh1, bl1);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
          mma3(acc[mf][nf], ah[mf], al[mf], bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();
  }
  float* c = Cm + z * st.c_z;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * mf + g + 8 * (e >> 1);
        const int n = n0 + wn + 8 * nf + 2 * t + (e & 1);
        if (m < M && n < N) c[m * st.c_m + n * st.c_n] = alpha * acc[mf][nf][e];
      }
}

// Absolute position of table slot s (see paged_attention.cu).
__device__ __forceinline__ int key_pos(int s, int ring, int newest, int cap) {
  if (!ring) return s;
  int d = (newest - s) % cap;
  if (d < 0) d += cap;
  return newest - d;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// part (nsplit, B*C*H, R + 2): per query row the part's unnormalised
// accumulator of weighted latents, then its running max and sum.
__global__ void mla_walk_kernel(
    const float* __restrict__ q, const float* __restrict__ q_lat,
    const float* __restrict__ ckv, const float* __restrict__ krope,
    const int32_t* __restrict__ table, const int32_t* __restrict__ kv_len,
    const int32_t* __restrict__ q_off, const int32_t* __restrict__ newest_pos,
    float* __restrict__ part, int B, int C, int H, int R, int Dr, int nope,
    int BS, int MB, int causal, int window, int ring, int nsplit,
    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, split = blockIdx.z;
  const int rows = C * H;
  const int r0 = blockIdx.y * RT, nr = min(RT, rows - r0);
  const int W = R + Dr, ldw = W + 1, Dq = nope + Dr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Qs = smem;                  // [RT][ldw]: q_lat ++ scale * q_rope
  float* Ks = Qs + RT * ldw;         // [BS][ldw]: c_kv ++ k_rope of a block
  float* Acc = Ks + BS * ldw;        // [RT][R]
  float* P = Acc + RT * R;           // [RT][BS]: scores, then weights
  float* Mx = P + RT * BS;           // [RT] running max
  float* Lx = Mx + RT;               // [RT] running sum
  float* Al = Lx + RT;               // [RT] this block's rescale

  const size_t row0 = (size_t)b * rows + r0;
  for (int e = tid; e < nr * W; e += blockDim.x) {
    const int r = e / W, d = e - r * W;
    Qs[r * ldw + d] = d < R ? q_lat[(row0 + r) * R + d]
                            : scale * q[(row0 + r) * Dq + nope + (d - R)];
  }
  for (int e = tid; e < nr * R; e += blockDim.x) Acc[e] = 0.f;
  for (int r = tid; r < nr; r += blockDim.x) {
    Mx[r] = NEG_INF;
    Lx[r] = 0.f;
  }

  const int len = kv_len[b], qoff = q_off[b];
  const int newest = ring ? newest_pos[b] : 0, cap = MB * BS;
  const int qlo = qoff + r0 / H, qhi = qoff + (r0 + nr - 1) / H;
  int nblk = MB;                     // a ring walks the whole table
  if (!ring) {
    int kmax = len;
    if (causal) kmax = min(kmax, qhi + 1);
    nblk = kmax > 0 ? min(MB, (kmax + BS - 1) / BS) : 0;
  }
  const int per = (nblk + nsplit - 1) / nsplit;
  const int i_end = min(nblk, (split + 1) * per);

  for (int i = split * per; i < i_end; ++i) {
    int vis = 0;                     // a slot some query of the tile sees?
    for (int j = tid; j < BS; j += blockDim.x) {
      const int kpos = key_pos(i * BS + j, ring, newest, cap);
      bool v = kpos >= 0 && kpos < len;
      if (causal) v = v && kpos <= qhi;
      if (window > 0) v = v && qlo - kpos < window;
      vis |= (int)v;
    }
    if (!__syncthreads_or(vis)) continue;   // block-uniform
    const size_t phys = (size_t)table[(size_t)b * MB + i];
    const int W4 = W / 4;            // 16-byte loads, several in flight
#pragma unroll 4
    for (int e = tid; e < BS * W4; e += blockDim.x) {
      const int j = e / W4, d = 4 * (e - j * W4);
      const float4 v = d < R
          ? *reinterpret_cast<const float4*>(ckv + (phys * BS + j) * R + d)
          : *reinterpret_cast<const float4*>(krope + (phys * BS + j) * Dr +
                                             (d - R));
      float* dst = Ks + j * ldw + d;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
    for (int e = tid; e < nr * BS; e += blockDim.x) {
      const int r = e / BS, j = e - r * BS;
      const int kpos = key_pos(i * BS + j, ring, newest, cap);
      const int qpos = qoff + (r0 + r) / H;
      bool valid = kpos >= 0 && kpos < len;
      if (causal) valid = valid && qpos >= kpos;
      if (window > 0) valid = valid && qpos - kpos < window;
      float s = -INFINITY;           // masked: weight exactly 0 below
      if (valid) {
        const float* qr = Qs + r * ldw;
        const float* kr = Ks + j * ldw;
        float dot = 0.f;
        for (int d = 0; d < W; ++d) dot += qr[d] * kr[d];
        s = dot;
      }
      P[r * BS + j] = s;
    }
    __syncthreads();
    for (int r = warp; r < nr; r += blockDim.x >> 5) {
      const float m_prev = Mx[r];
      float mx = -INFINITY;
      for (int j = lane; j < BS; j += 32) mx = fmaxf(mx, P[r * BS + j]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f;
      for (int j = lane; j < BS; j += 32) {
        const float s = P[r * BS + j];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        P[r * BS + j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        Al[r] = a;
        Lx[r] = Lx[r] * a + psum;
        Mx[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < nr * R; e += blockDim.x) {
      const int r = e / R, d = e - r * R;
      const float* pr = P + r * BS;
      float o = Acc[e] * Al[r];
      for (int j = 0; j < BS; ++j) o += pr[j] * Ks[j * ldw + d];
      Acc[e] = o;
    }
    __syncthreads();
  }

  __syncthreads();
  float* dst = part + ((size_t)split * B * rows + row0) * (R + 2);
  for (int e = tid; e < nr * R; e += blockDim.x) {
    const int r = e / R, d = e - r * R;
    dst[(size_t)r * (R + 2) + d] = Acc[e];
  }
  for (int r = tid; r < nr; r += blockDim.x) {
    dst[(size_t)r * (R + 2) + R] = Mx[r];
    dst[(size_t)r * (R + 2) + R + 1] = Lx[r];
  }
}

// merged[row, :] = sum_s acc_s e^(m_s - m) / sum_s l_s e^(m_s - m); a
// row no part saw a key for has m_s = -1e30, l_s = 0, acc_s = 0 and
// comes out 0.
__global__ void mla_merge_kernel(const float* __restrict__ part,
                                 float* __restrict__ merged, int rows_total,
                                 int R, int nsplit) {
  const size_t row = blockIdx.x;
  const size_t stride = (size_t)rows_total * (R + 2);
  const float* p = part + row * (R + 2);
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, p[s * stride + R]);
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s)
    l += p[s * stride + R + 1] * expf(p[s * stride + R] - m);
  const float inv = 1.f / fmaxf(l, 1e-20f);
  for (int d = threadIdx.x; d < R; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < nsplit; ++s)
      o += p[s * stride + d] * expf(p[s * stride + R] - m);
    merged[row * R + d] = o * inv;
  }
}

// ------------------------------------------------------ the tiled walk
//
// Prefill chunks (C * H > RT query rows per batch row) at R = 512,
// Dr = 64.  A block owns TQ = 64 query rows (4 positions x 16 heads at
// H = 16) of one batch row: every latent key is staged once for all 64
// rows, 4x the decode walk's reuse.  The absorbed query tile ([64][576]
// floats, q_lat ++ scale * q_rope) is staged once; latent tiles of
// TK = 16 keys (c_kv ++ k_rope) come in by cp.async, double-buffered
// (any BS: a slot's block is looked up per slot).  Both are stored
// swizzled, the 16-byte chunk c of row r at chunk c ^ pi(r % 8), so
// that the fragment loads of Q . K^T (8 bytes a lane, rows g = 0..7)
// and of P . K (4 bytes a lane, keys 2t, 2t + 1) hit 32 distinct banks
// without row padding: Q (147,456 B) + two stages (73,728 B) + the
// score halves (8,192 B) + the rescale (256 B) = 229,632 B, one block
// per SM.  Per stage, with 8 warps:
//   scores  warp (mw, kh) computes rows 16 mw.. x the 16 keys over half
//           kh of the 576 dims (36 m16n8k8 steps, 3xTF32) and stores
//           its partial sums;
//   softmax 4 threads per row, 4 keys each: the two halves summed, the
//           per-key masks applied exactly, the row's (m, l) kept in
//           registers, the weights P written over half 0;
//   P . K   warp w owns output columns 64 w.. of all 64 rows (a 64 x 64
//           accumulator, 128 floats a thread, in registers), rescales
//           it and adds P . c_kv over the 16 keys (3xTF32).
// The walk covers only the slots that can hold a visible key: positions
// [qlo - window + 1, qhi] (clipped to [0, kv_len)) map to one arc of
// slots, modulo the ring's capacity on a ring (as paged_attention.cu's
// tiled path); tiles the arc misses are skipped.  A row that saw no key
// writes zeros.
namespace tiled {
constexpr int R = 512, DR = 64, W = R + DR;   // latent, rope, key row width
constexpr int TQ = 64;                        // query rows per block
constexpr int TK = 16;                        // keys per stage
constexpr int THREADS = 256;
constexpr int WCH = W / 4;                    // 16-byte chunks of a row
constexpr int KH = W / 2;                     // score dims per warp half
constexpr size_t SMEM =
    sizeof(float) * ((size_t)TQ * W + 2 * TK * W + 2 * TQ * TK + TQ);

// Offset of (row, col) in a swizzled [rows][W] tile.  pi is a
// permutation of 0..7 whose top two bits differ across rows {0..3},
// {4..7}, {0,2,4,6} and {1,3,5,7}: the row sets of the fragment loads.
__device__ __forceinline__ int pi8(int row) {
  const int k = row & 7;
  return ((k >> 1) & 1) << 2 | ((k ^ (k >> 2)) & 1) << 1 | (k & 1);
}
__device__ __forceinline__ int swz(int row, int col) {
  return row * W + (((col >> 2) ^ pi8(row)) << 2) + (col & 3);
}

// Offset of (row, key) in a [TQ][TK] score tile: keys 8.. and ..7 swap
// on rows 2, 3 (mod 4), so rows g and g + 2 of a fragment do not share
// banks.
__device__ __forceinline__ int pidx(int row, int key) {
  return row * TK + (key ^ (((row >> 1) & 1) << 3));
}
}  // namespace tiled

__global__ __launch_bounds__(tiled::THREADS, 1) void mla_tiled_kernel(
    const float* __restrict__ q, const float* __restrict__ q_lat,
    const float* __restrict__ ckv, const float* __restrict__ krope,
    const int32_t* __restrict__ table, const int32_t* __restrict__ kv_len,
    const int32_t* __restrict__ q_off, const int32_t* __restrict__ newest_pos,
    float* __restrict__ merged, int B, int C, int H, int nope, int BS,
    int MB, int causal, int window, int ring, float scale) {
  using namespace tiled;
  extern __shared__ __align__(16) float smem[];
  __shared__ int b_of_rank;
  float* Qs = smem;                    // [TQ][W] swizzled
  float* Ks = Qs + TQ * W;             // [2][TK][W] swizzled
  float* Sp = Ks + 2 * TK * W;         // [2][TQ][TK]: score halves; P in 0
  float* Al = Sp + 2 * TQ * TK;        // [TQ]: rescale; at the end 1 / l
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // Blocks start in order of blockIdx: the batch rows with the most keys
  // to walk go first (blockIdx.y is the rank of the row's last visible
  // position, ties by row), and within a row the later query tiles, so
  // that the last blocks to start are the shortest.
  for (int i = tid; i < B; i += THREADS) {
    auto work = [&](int j) {
      const int n = causal ? min(kv_len[j], q_off[j] + C) : kv_len[j];
      return ring ? min(n, MB * BS) : n;
    };
    const int wi = work(i);
    int rank = 0;
    for (int j = 0; j < B; ++j) {
      const int wj = work(j);
      rank += wj > wi || (wj == wi && j < i);
    }
    if (rank == (int)blockIdx.y) b_of_rank = i;
  }
  __syncthreads();
  const int b = b_of_rank, rows = C * H, Dq = nope + DR;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * TQ, nr = min(TQ, rows - r0);
  const size_t row0 = (size_t)b * rows + r0;

  for (int e = tid; e < TQ * WCH; e += THREADS) {
    const int r = e / WCH, c = e % WCH;
    float* dst = Qs + swz(r, 4 * c);
    if (r >= nr) {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (c < R / 4) {
      cp_async16(dst, q_lat + (row0 + r) * R + 4 * c, 16);
    } else {
      float4 v = *reinterpret_cast<const float4*>(
          q + (row0 + r) * Dq + nope + 4 * (c - R / 4));
      v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
      *reinterpret_cast<float4*>(dst) = v;
    }
  }

  const int len = kv_len[b], qoff = q_off[b];
  const int newest = ring ? newest_pos[b] : 0, cap = MB * BS;
  const int qlo = qoff + r0 / H, qhi = qoff + (r0 + nr - 1) / H;
  // the arc [alo, alo + an) of slots (mod cap) that can hold a visible key
  const int lo = window > 0 ? max(0, qlo - window + 1) : 0;
  int hi = causal ? min(len - 1, qhi) : len - 1;
  if (!ring) hi = min(hi, cap - 1);
  int alo = 0, an = hi - lo + 1;
  if (an >= cap) {
    an = cap;
  } else if (an > 0) {
    alo = ring ? lo % cap : lo;        // lo >= 0: floor modulo
  } else {
    an = 0;
  }
  const int ntiles = (cap + TK - 1) / TK;
  auto next_tile = [&](int tt) {       // first tile >= tt the arc touches
    for (; tt < ntiles; ++tt) {
      const int ts = tt * TK, te = min(cap, ts + TK);
      if (max(ts, alo) < min(te, alo + an)) break;
      if (alo + an > cap && ts < alo + an - cap) break;   // wrapped part
    }
    return tt;
  };
  auto load_k = [&](int st, int tt) {
    for (int e = tid; e < TK * WCH; e += THREADS) {
      const int j = e / WCH, c = e % WCH, slot = tt * TK + j;
      float* dst = Ks + st * TK * W + swz(j, 4 * c);
      if (slot < cap) {
        const size_t key =
            (size_t)table[(size_t)b * MB + slot / BS] * BS + slot % BS;
        cp_async16(dst, c < R / 4 ? ckv + key * R + 4 * c
                                  : krope + key * DR + 4 * (c - R / 4), 16);
      } else {                         // past the table: zeros, masked
        cp_async16(dst, ckv, 0);
      }
    }
  };

  // softmax role: row sr, keys 4 sq .. 4 sq + 3 of each stage
  const int sr = tid >> 2, sq = tid & 3;
  const int qpos = qoff + (r0 + sr) / H;
  float m_run = NEG_INF, l_run = 0.f;
  // scores role: rows 16 mw.., dims kh * KH..; P . K role: columns 64 warp..
  const int mw = warp & 3, kh = warp >> 2;
  // swizzled offsets within a row, fixed per thread: the score loads
  // (rows = g mod 8, dims 8 ks + 2t at ks = 4j + u: chunk 8j + 2u + t/2)
  // and the P . K loads (keys 2t and 2t + 1, dims 8 nf + g at nf = 4a + v:
  // chunk 8a + 2v + g/4); rows 2 and 3 (mod 4) of a score tile swap
  // their key halves (pidx)
  int soff[4], poff[2][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    soff[u] = (((2 * u + (t >> 1)) ^ pi8(g)) << 2) + 2 * (t & 1);
    poff[0][u] = (((2 * u + (g >> 2)) ^ pi8(2 * t)) << 2) + (g & 3);
    poff[1][u] = (((2 * u + (g >> 2)) ^ pi8(2 * t + 1)) << 2) + (g & 3);
  }
  const int gb = (g >> 1) & 1;
  float o[4][8][4];
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int nf = 0; nf < 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mf][nf][e] = 0.f;

  int tt = next_tile(0), st = 0;
  if (tt < ntiles) load_k(0, tt);
  asm volatile("cp.async.commit_group;\n" ::);
  while (tt < ntiles) {                // block-uniform
    const int tn = next_tile(tt + 1);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();                   // Q, tile tt in; stage st ^ 1 free
    if (tn < ntiles) load_k(st ^ 1, tn);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* K = Ks + st * TK * W;

    float s[2][4] = {};
    const float* qrow = Qs + (16 * mw + g) * W + kh * KH;
    const float* krow = K + g * W + kh * KH;
#pragma unroll 1
    for (int j = 0; j < KH / 32; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = 32 * j + soff[u];
        uint32_t ah[4], al[4];
        split_a(*reinterpret_cast<const float2*>(qrow + o),
                *reinterpret_cast<const float2*>(qrow + 8 * W + o), ah, al);
#pragma unroll
        for (int nf = 0; nf < 2; ++nf) {
          const float2 y =
              *reinterpret_cast<const float2*>(krow + 8 * nf * W + o);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(y.x, bh0, bl0);
          split_tf32(y.y, bh1, bl1);
          mma3(s[nf], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    float* half = Sp + kh * TQ * TK + (16 * mw + g) * TK + 2 * t;
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
      *reinterpret_cast<float2*>(half + 8 * (nf ^ gb)) =
          make_float2(s[nf][0], s[nf][1]);
      *reinterpret_cast<float2*>(half + 8 * TK + 8 * (nf ^ gb)) =
          make_float2(s[nf][2], s[nf][3]);
    }
    __syncthreads();                   // both halves of every score

    {
      float* pr = Sp + pidx(sr, 4 * sq);
      const float4 h0 = *reinterpret_cast<const float4*>(pr);
      const float4 h1 = *reinterpret_cast<const float4*>(pr + TQ * TK);
      const float sv[4] = {h0.x + h1.x, h0.y + h1.y, h0.z + h1.z,
                           h0.w + h1.w};
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int slot = tt * TK + 4 * sq + j;
        const int kpos = key_pos(slot, ring, newest, cap);
        bool v = sr < nr && slot < cap && kpos >= 0 && kpos < len;
        if (causal) v = v && qpos >= kpos;
        if (window > 0) v = v && qpos - kpos < window;
        valid[j] = v;
        if (v) mx = fmaxf(mx, sv[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float a = expf(m_run - m_new);
      float p[4], psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = valid[j] ? expf(sv[j] - m_new) : 0.f;
        psum += p[j];
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run = l_run * a + psum;
      m_run = m_new;
      *reinterpret_cast<float4*>(pr) = make_float4(p[0], p[1], p[2], p[3]);
      if (sq == 0) Al[sr] = a;
    }
    __syncthreads();                   // the weights and rescales

#pragma unroll
    for (int mf = 0; mf < 4; ++mf) {
      const float a0 = Al[16 * mf + g], a1 = Al[16 * mf + 8 + g];
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        o[mf][nf][0] *= a0;
        o[mf][nf][1] *= a0;
        o[mf][nf][2] *= a1;
        o[mf][nf][3] *= a1;
      }
    }
#pragma unroll
    for (int ks = 0; ks < TK / 8; ++ks) {
      const float* prow = Sp + g * TK + 8 * (ks ^ gb) + 2 * t;
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int mf = 0; mf < 4; ++mf)
        split_a(*reinterpret_cast<const float2*>(prow + 16 * mf * TK),
                *reinterpret_cast<const float2*>(prow + (16 * mf + 8) * TK),
                ph[mf], pl[mf]);
      const float* k0 = K + (8 * ks + 2 * t) * W + 64 * warp;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(k0[32 * (nf >> 2) + poff[0][nf & 3]], bh0, bl0);
        split_tf32(k0[W + 32 * (nf >> 2) + poff[1][nf & 3]], bh1, bl1);
#pragma unroll
        for (int mf = 0; mf < 4; ++mf)
          mma3(o[mf][nf], ph[mf], pl[mf], bh0, bh1, bl0, bl1);
      }
    }
    tt = tn;
    st ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();                     // the last stage's rescales read
  if (sq == 0) Al[sr] = 1.f / fmaxf(l_run, 1e-20f);
  __syncthreads();
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mf + 8 * h + g;
      if (r >= nr) continue;
      const float inv = Al[r];
      float* dst = merged + (row0 + r) * R + 64 * warp + 2 * t;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
        *reinterpret_cast<float2*>(dst + 8 * nf) =
            make_float2(o[mf][nf][2 * h] * inv, o[mf][nf][2 * h + 1] * inv);
    }
}

}  // namespace

// tiled_walk != 0 takes the tiled walk (R = 512, Dr = 64, q and merged
// 16-byte aligned) and needs no `part`; otherwise the decode walk over
// `nsplit` parts of (nsplit, B*C*H, R + 2) floats and the merge.  The
// GEMMs read q, k_up, v_up and merged 16 bytes at a time: nope, Dr, Dv
// and R are multiples of 4 and the four are 16-byte aligned.
extern "C" int pm_paged_attention_mla(
    const void* q, const void* ckv, const void* krope, const void* table,
    const void* kv_len, const void* q_off, const void* newest,
    const void* k_up, const void* v_up, void* q_lat, void* part,
    void* merged, void* out, int B, int C, int H, int R, int Dr, int nope,
    int Dv, int BS, int MB, int causal, int window, int ring, int nsplit,
    int tiled_walk, float scale, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  const auto a16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  if (H <= 0 || R <= 0 || Dr <= 0 || nope <= 0 || Dv <= 0 || BS <= 0 ||
      MB <= 0 || nsplit <= 0 || (ring && newest == nullptr) || R % 4 ||
      Dr % 4 || nope % 4 || Dv % 4 || !a16(ckv) || !a16(krope) || !a16(q) ||
      !a16(k_up) || !a16(v_up) || !a16(q_lat) || !a16(merged) ||
      (tiled_walk ? R != tiled::R || Dr != tiled::DR || nsplit != 1
             : part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * C, rows = C * H, Dq = nope + Dr;

  // 1. absorb k_up into the query: q_lat (B*C, H, R)
  const Strides s1 = {Dq, (long long)H * Dq, 1, nope, 1, (long long)H * nope,
                      R, (long long)H * R, 1};
  const dim3 g1((R + GT - 1) / GT, (M + GT - 1) / GT, H);
  tf32x3_gemm_kernel<<<g1, GTHREADS, 0, st>>>(
      (const float*)q, (const float*)k_up, (float*)q_lat, M, R, nope, s1,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2. the walk over the latent blocks (3. merge its parts)
  if (tiled_walk) {
    static size_t granted[dyn_smem::MAX_DEVICES] = {};
    err = dyn_smem::opt_in(mla_tiled_kernel, tiled::SMEM, granted);
    if (err != cudaSuccess) return (int)err;
    const dim3 g2((rows + tiled::TQ - 1) / tiled::TQ, B);
    mla_tiled_kernel<<<g2, tiled::THREADS, tiled::SMEM, st>>>(
        (const float*)q, (const float*)q_lat, (const float*)ckv,
        (const float*)krope, (const int32_t*)table, (const int32_t*)kv_len,
        (const int32_t*)q_off, (const int32_t*)newest, (float*)merged, B, C,
        H, nope, BS, MB, causal, window, ring, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else {
    const size_t ldw = (size_t)R + Dr + 1;
    const size_t smem = sizeof(float) * ((size_t)RT * ldw + (size_t)BS * ldw +
                                         (size_t)RT * R + (size_t)RT * BS +
                                         3 * RT);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    static size_t granted[dyn_smem::MAX_DEVICES] = {};
    err = dyn_smem::opt_in(mla_walk_kernel, smem, granted);
    if (err != cudaSuccess) return (int)err;
    const dim3 g2(B, (rows + RT - 1) / RT, nsplit);
    mla_walk_kernel<<<g2, WALK_THREADS, smem, st>>>(
        (const float*)q, (const float*)q_lat, (const float*)ckv,
        (const float*)krope, (const int32_t*)table, (const int32_t*)kv_len,
        (const int32_t*)q_off, (const int32_t*)newest, (float*)part, B, C, H,
        R, Dr, nope, BS, MB, causal, window, ring, nsplit, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mla_merge_kernel<<<B * rows, 128, 0, st>>>((const float*)part,
                                               (float*)merged, B * rows, R,
                                               nsplit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // 4. decompress V after the walk: out (B*C, H, Dv)
  const Strides s4 = {R, (long long)H * R, 1, Dv, (long long)H * Dv, 1,
                      Dv, (long long)H * Dv, 1};
  const dim3 g4((Dv + GT - 1) / GT, (M + GT - 1) / GT, H);
  tf32x3_gemm_kernel<<<g4, GTHREADS, 0, st>>>(
      (const float*)merged, (const float*)v_up, (float*)out, M, Dv, R, s4,
      1.f);
  return (int)cudaGetLastError();
}
