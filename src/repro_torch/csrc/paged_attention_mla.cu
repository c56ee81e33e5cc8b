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
// function in the absorbed order, in three launches on one stream:
//   1. q_lat[b, c, h, :] = scale * q_nope[b, c, h] . k_up[:, h]^T  (R wide);
//   2. the walk, with an online softmax over an R-wide accumulator of
//      the weighted LATENTS per query row, normalised at its end;
//   3. out[b, c, h, :] = acc[b, c, h] . v_up[:, h].
// Two routes, chosen by the wrapper (kernels/paged_attention.mla_tiled):
//   * decode (C * H <= 16 query rows per batch row, or widths other than
//     R = 512, Dr = 64): the two small-M GEMMs (float32 on CUDA cores)
//     and the split decode walk below (3xTF32 on tensor cores);
//   * prefill (more query rows): the 3xTF32 tensor-core GEMM
//     (tf32x3_gemm_kernel) and the tiled walk (mla_tiled_kernel).
// Every decode launch sums each output element in an order fixed by
// that element's own row and positions: a row's result does not depend
// on the batch it runs in, nor on the card.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int RT = 8;             // query rows (c, h) a decode block owns
constexpr int MR = 16;            // rows of its mma tiles (RT.. are zeros)
constexpr int PART_KEYS = 128;    // positions per part of the decode walk
constexpr int DK = 16;            // keys per staged latent tile
constexpr int STAGES = 2;         // latent tile stages: one loads, one is used
constexpr int WALK_THREADS = 256; // 8 warps
constexpr int WALK_WARPS = WALK_THREADS / 32;
constexpr int MAX_R = 512;        // latent width the decode walk holds
constexpr int GM = 16;            // rows of a small-M GEMM block
constexpr int GT = 64;            // tiled GEMM output tile (GT x GT)
constexpr int GK = 32;            // tiled GEMM K tile
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

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------- small-M decode GEMMs
//
// At decode the two GEMMs have M = B * C <= 16 rows per head and read a
// 4 MB weight each: they are bound by streaming that weight once.  Both
// give each block a slab of weight columns for GM rows (more rows take
// more blocks along z, each reading the slab again, from L2), and sum
// every output in an order that depends only on its own column: the
// result of a row does not depend on how many rows came with it.

// q_lat[m, h, r] = scale * sum_n q[m, h, n] k_up[r, h * nope + n], for
// m < M = B * C.  Block (r slab of 32, head h, rows GM z..): the slab's
// 32 k_up rows (32 x nope floats, contiguous per row) and the GM query
// rows are staged in shared memory; thread (column j, row group g) sums
// rows g and g + 8 serially over n.  Grid (ceil(R / 32), H, ceil(M / GM)).
__global__ __launch_bounds__(256) void absorb_small_kernel(
    const float* __restrict__ q, const float* __restrict__ k_up,
    float* __restrict__ q_lat, int M, int H, int R, int nope, int Dq,
    float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldw = nope + 4;          // 16-byte rows, 8 lanes on 32 banks
  float* Ws = smem;                  // [32][ldw]
  float* As = Ws + 32 * ldw;         // [GM][nope]
  const int h = blockIdx.y, r0 = blockIdx.x * 32, m0 = blockIdx.z * GM;
  const int mr = min(GM, M - m0), nc = nope / 4, tid = threadIdx.x;
  for (int e = tid; e < 32 * nc; e += 256) {
    const int j = e / nc, c = e - j * nc, r = r0 + j;
    const float4 v = r < R ? ld4(k_up + (size_t)r * H * nope + h * nope + 4 * c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(Ws + j * ldw + 4 * c) = v;
  }
  for (int e = tid; e < mr * nc; e += 256) {
    const int m = e / nc, c = e - m * nc;
    *reinterpret_cast<float4*>(As + m * nope + 4 * c) =
        ld4(q + ((size_t)(m0 + m) * H + h) * Dq + 4 * c);
  }
  __syncthreads();
  const int j = tid & 31, g = tid >> 5, r = r0 + j;
  if (r >= R) return;
  for (int m = g; m < mr; m += 8) {
    float d = 0.f;
    for (int c = 0; c < nc; ++c)
      d += dot4(ld4(As + m * nope + 4 * c), ld4(Ws + j * ldw + 4 * c));
    q_lat[((size_t)(m0 + m) * H + h) * R + r] = scale * d;
  }
}

// out[m, h, v] = sum_r merged[m, h, r] v_up[r, h * Dv + v].  Block
// (v slab of 8, head h, rows GM z..): the GM merged rows of head h are
// staged in shared memory; thread (column j, part p) sums r = p, p + 32,
// ... serially for all rows, reading v_up straight from memory (8
// neighbouring columns, 32 bytes, a row); the 32 parts are then added
// in part order.  Grid (ceil(Dv / 8), H, ceil(M / GM)).
__global__ __launch_bounds__(256) void v_up_small_kernel(
    const float* __restrict__ merged, const float* __restrict__ v_up,
    float* __restrict__ out, int M, int H, int R, int Dv) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                  // [GM][R]
  float* Red = As + GM * R;          // [32][GM][8]
  const int h = blockIdx.y, v0 = blockIdx.x * 8, m0 = blockIdx.z * GM;
  const int mr = min(GM, M - m0), tid = threadIdx.x, rc = R / 4;
  for (int e = tid; e < mr * rc; e += 256) {
    const int m = e / rc, c = e - m * rc;
    *reinterpret_cast<float4*>(As + m * R + 4 * c) =
        ld4(merged + ((size_t)(m0 + m) * H + h) * R + 4 * c);
  }
  __syncthreads();
  const int j = tid & 7, p = tid >> 3, v = v0 + j;
  float acc[GM];
#pragma unroll
  for (int m = 0; m < GM; ++m) acc[m] = 0.f;
  if (v < Dv) {
    const float* w = v_up + (size_t)h * Dv + v;
    const size_t ldv = (size_t)H * Dv;
#pragma unroll 4
    for (int r = p; r < R; r += 32) {
      const float wr = __ldg(w + r * ldv);
#pragma unroll
      for (int m = 0; m < GM; ++m)
        if (m < mr) acc[m] += As[m * R + r] * wr;
    }
  }
#pragma unroll
  for (int m = 0; m < GM; ++m) Red[(p * GM + m) * 8 + j] = acc[m];
  __syncthreads();
  if (tid >= GM * 8) return;
  const int m = tid >> 3, jj = tid & 7;
  if (m >= mr || v0 + jj >= Dv) return;
  float o = 0.f;
  for (int pp = 0; pp < 32; ++pp) o += Red[(pp * GM + m) * 8 + jj];
  out[((size_t)(m0 + m) * H + h) * Dv + v0 + jj] = o;
}

// ------------------------------------------------------ the decode walk
//
// The TPU walked the table as a sequential grid axis; at decode that is
// one serial walk per batch row, 8 of them at deepseek's B = 8.  Here,
// as paged_attention.cu's GQA decode walk, the walk runs in POSITION
// space: the keys a tile of RT query rows can see are the positions
// [lo, hi] (kv_len, the causal bound, the window, and on a ring the
// capacity behind `newest`), each at table slot p (paged) or
// p mod (MB * BS) (ring), so a ring walks only its visible arc.
// Positions are cut into parts of PART_KEYS: one block walks one part of
// one (batch row, row tile), and the grid has `nsplit` blocks a row
// tile, sized from the table width alone
// (kernels/paged_attention.mla_decode_parts); a block past its row's
// last part exits at once.
// A block owns RT = 8 query rows (half of deepseek's 16 heads of one
// position) and computes them as the top half of 16-row mma tiles: the
// last part of a row tile merges every part's R-wide accumulators alone,
// at one SM's read rate, so 8 rows a block halve that critical path and
// double the blocks that share the latent reads.
// Each latent tile of DK keys (c_kv ++ k_rope, 2304 bytes a key at
// deepseek's widths) comes in by bulk copies (TMA, two a key, one lane
// a key spread over the 8 warps, counted on an mbarrier), STAGES deep: a
// per-thread cp.async of 16 bytes could not be issued fast enough.  Keys
// outside the part copy a real latent row too (finite values) and are
// masked.  Both products run on tensor cores in 3xTF32 (mma3, as the
// tiled walk), each 8-deep step summed from zero; on CUDA cores the
// 576-wide products of a tile waited on shared memory.  Per tile, with
// 8 warps:
//   scores  warp w multiplies its eighth of the key width, 9 k-steps of
//           8, for all MR x DK (row, key) pairs; its query fragments (hi
//           and lo parts) stay in registers for the whole part; the 8
//           warps' partial sums are added in warp order;
//   softmax thread (row, key): masks, the row's max and sum over the
//           tile by shuffles among its 16 threads, the running (m, l)
//           kept by each of them;
//   P . K   warp w keeps the accumulator of the MR rows for its 64 of
//           the R latent dims in registers, rescales it and adds the
//           tile's weighted latents.
// A row that needs one part writes its normalised accumulator; otherwise
// each part stores (acc, m, l) to a scratch, bumps its row tile's
// counter, and the last part to arrive merges the parts in part order,
// divides, writes and leaves the counter at 0 for the next launch (the
// protocol of paged_attention.cu's decode walk).  Softmax state is
// float32; masked keys weigh exactly 0 and a row that sees no key
// writes zeros.

constexpr int KSW = 9;            // k-steps of 8 dims a warp scores (W <= 576)

// Parts of PART_KEYS positions the grid must give a row tile.  Mirrored
// by kernels/paged_attention.mla_decode_parts.
inline int decode_parts(int cap, int ring) {
  return ring ? (cap - 1 + PART_KEYS - 1) / PART_KEYS + 1
              : (cap + PART_KEYS - 1) / PART_KEYS;
}

// Shared memory of the decode walk for key width W (= R + Dr): the
// stages, the partial scores, the weights, the row state, the part's
// latent rows and the stages' mbarriers.
inline size_t walk_smem(int W) {
  const size_t wp = (size_t)W + 4;
  return sizeof(float) * ((size_t)STAGES * DK * wp +
                          (size_t)WALK_WARPS * MR * DK + MR * (DK + 8) +
                          3 * MR) +
         sizeof(long long) * PART_KEYS + sizeof(uint64_t) * STAGES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "wait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Grid (nsplit, row tiles, B).  `part` (B, row tiles * RT, nsplit,
// R + 4) floats and `counters` (B * row tiles) ints, 0 between
// launches; both unused when nsplit == 1.  merged (B * C * H, R).
__global__ __launch_bounds__(WALK_THREADS, 1) void mla_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ q_lat,
    const float* __restrict__ ckv, const float* __restrict__ krope,
    const int32_t* __restrict__ table, const int32_t* __restrict__ kv_len,
    const int32_t* __restrict__ q_off, const int32_t* __restrict__ newest_pos,
    float* __restrict__ merged, float* __restrict__ part,
    int* __restrict__ counters, int C, int H, int R, int Dr, int nope, int BS,
    int MB, int causal, int window, int ring, int nsplit, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.x, rt = blockIdx.y, ntiles = gridDim.y;
  const int b = blockIdx.z, rows = C * H;
  const int r0 = rt * RT, nr = min(RT, rows - r0);
  const int W = R + Dr, WP = W + 4, RCH = R / 4;
  const int Dq = nope + Dr, cap = MB * BS;
  const int len = kv_len[b], qoff = q_off[b];
  const int qlo = qoff + r0 / H, qhi = qoff + (r0 + nr - 1) / H;

  // the positions [lo, hi] some row of the tile can see; its parts
  int lo = window > 0 ? max(0, qlo - window + 1) : 0;
  int hi = causal ? min(len - 1, qhi) : len - 1;
  if (ring) {
    const int nw = newest_pos[b];
    hi = min(hi, nw);
    lo = max(lo, nw - cap + 1);
  } else {
    hi = min(hi, cap - 1);
  }
  const int kf = lo / PART_KEYS;
  const int nlive = hi >= lo ? hi / PART_KEYS - kf + 1 : 1;
  if (z >= nlive) return;                       // past this row's arc
  const int ps = max(lo, (kf + z) * PART_KEYS);
  const int pe = min(hi, (kf + z + 1) * PART_KEYS - 1);

  constexpr int PLD = DK + 8;                   // weights' row stride
  float* Ks = smem;                             // [STAGES][DK][WP]
  float* Sp = Ks + STAGES * DK * WP;            // [warps][MR][DK] partials
  float* Ps = Sp + WALK_WARPS * MR * DK;        // [MR][PLD] weights
  float* Al = Ps + MR * PLD;                    // [MR] rescale
  float* Mx = Al + MR;                          // [MR] the part's max
  float* Lx = Mx + MR;                          // [MR] the part's sum
  long long* Off = reinterpret_cast<long long*>(Lx + MR);  // [PART_KEYS]
  uint64_t* bar = reinterpret_cast<uint64_t*>(Off + PART_KEYS);  // [STAGES]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * rows + r0;

  // tiles of DK positions, aligned to DK, covering [ps, pe]; the latent
  // row of every key (row 0 of the pools outside [ps, pe]: masked)
  const int ts0 = ps / DK * DK;
  const int ntile = ps <= pe ? (pe - ts0) / DK + 1 : 0;
  for (int i = tid; i < ntile * DK; i += WALK_THREADS) {
    const int p = ts0 + i;
    long long key = -1;
    if (p >= ps && p <= pe) {
      const int slot = ring ? p % cap : p;
      key = (long long)table[(size_t)b * MB + slot / BS] * BS + slot % BS;
    }
    Off[i] = key;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(bar + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                              // offsets, barriers
  const uint32_t tile_bytes = (uint32_t)(DK * W * 4);
  // tile tt into stage st: warp w copies keys w * DK / 8 .., one lane a
  // key (bulk copies issued by one warp queue behind each other); lane 0
  // of warp 0 arms the stage's mbarrier with the tile's bytes
  auto load = [&](int st, int tt) {
    if (warp == 0 && lane == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(bar + st)),
          "r"(tile_bytes)
          : "memory");
    if (lane < DK / WALK_WARPS) {
      const int j = warp * (DK / WALK_WARPS) + lane;
      const long long key = max(Off[tt * DK + j], 0LL);
      float* dst = Ks + (st * DK + j) * WP;
      bulk_copy(dst, ckv + key * R, R * 4, bar + st);
      bulk_copy(dst + R, krope + key * Dr, Dr * 4, bar + st);
    }
  };
  for (int s = 0; s < STAGES - 1 && s < ntile; ++s) load(s, s);

  // this warp's query fragments: rows g, g + 8 of q_lat ++ scale *
  // q_rope (zeros past nr and W), dims k0 + t, k0 + t + 4 of its
  // k-steps, split into TF32 hi and lo parts once for the whole part
  auto qval = [&](int r, int d) -> float {
    if (r >= nr || d >= W) return 0.f;
    return d < R ? q_lat[(row0 + r) * R + d]
                 : scale * q[(row0 + r) * Dq + nope + (d - R)];
  };
  uint32_t qh[KSW][4], ql[KSW][4];
#pragma unroll
  for (int kk = 0; kk < KSW; ++kk) {
    const int k0 = 8 * (KSW * warp + kk) + t;
    split_tf32(qval(g, k0), qh[kk][0], ql[kk][0]);
    split_tf32(qval(g + 8, k0), qh[kk][1], ql[kk][1]);
    split_tf32(qval(g, k0 + 4), qh[kk][2], ql[kk][2]);
    split_tf32(qval(g + 8, k0 + 4), qh[kk][3], ql[kk][3]);
  }

  // softmax role: row sr, keys sk + 16 u
  const int sr = tid >> 4, sk = tid & 15;
  const int qpos = qoff + (r0 + sr) / H;
  float m_run = NEG_INF, l_run = 0.f;
  // P . K role: rows g, g + 8, dims d0 + 8 nf + 2t (+1)
  const int d0 = 64 * warp;
  float o[8][4];
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;

  for (int tt = 0; tt < ntile; ++tt) {          // block-uniform
    const int st = tt % STAGES, tn = tt + STAGES - 1;
    if (tn < ntile) load(tn % STAGES, tn);      // consumed at tt - 1's end
    mbar_wait(bar + st, (uint32_t)(tt / STAGES) & 1u);
    const float* K = Ks + st * DK * WP;

    {
      float s[DK / 8][4];
#pragma unroll
      for (int nf = 0; nf < DK / 8; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nf][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSW; ++kk) {
        // past W the query fragment is 0: any key column will do
        const int k0 = min(8 * (KSW * warp + kk), W - 8);
#pragma unroll
        for (int nf = 0; nf < DK / 8; ++nf) {
          const float* kr = K + (8 * nf + g) * WP + k0 + t;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kr[0], bh0, bl0);
          split_tf32(kr[4], bh1, bl1);
          mma3(s[nf], qh[kk], ql[kk], bh0, bh1, bl0, bl1);
        }
      }
      float* sp = Sp + warp * MR * DK;
#pragma unroll
      for (int nf = 0; nf < DK / 8; ++nf) {
        *reinterpret_cast<float2*>(sp + g * DK + 8 * nf + 2 * t) =
            make_float2(s[nf][0], s[nf][1]);
        *reinterpret_cast<float2*>(sp + (g + 8) * DK + 8 * nf + 2 * t) =
            make_float2(s[nf][2], s[nf][3]);
      }
    }
    __syncthreads();             // every warp's partial scores

    {
      float sv[DK / 16];
      bool v[DK / 16];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < DK / 16; ++u) {
        const int key = sk + 16 * u;
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < WALK_WARPS; ++w)
          a += Sp[(w * MR + sr) * DK + key];
        const int p = ts0 + tt * DK + key;
        bool ok = sr < nr && p >= ps && p <= pe;
        if (causal) ok = ok && p <= qpos;
        if (window > 0) ok = ok && qpos - p < window;
        sv[u] = a;
        v[u] = ok;
        if (ok) mx = fmaxf(mx, a);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float a = expf(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < DK / 16; ++u) {
        const float pw = v[u] ? expf(sv[u] - m_new) : 0.f;
        Ps[sr * PLD + sk + 16 * u] = pw;
        psum += pw;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run = l_run * a + psum;
      m_run = m_new;
      if (sk == 0) Al[sr] = a;
    }
    __syncthreads();             // the weights and rescales

    {
      const float a0 = Al[g], a1 = Al[g + 8];
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        o[nf][0] *= a0; o[nf][1] *= a0;
        o[nf][2] *= a1; o[nf][3] *= a1;
      }
#pragma unroll
      for (int ks = 0; ks < DK / 8; ++ks) {
        // keys 8 ks + 2t, + 1 as the fragment's k = t, t + 4 (split_a)
        uint32_t ph[4], pl[4];
        split_a(*reinterpret_cast<const float2*>(Ps + g * PLD + 8 * ks + 2 * t),
                *reinterpret_cast<const float2*>(Ps + (g + 8) * PLD + 8 * ks +
                                                 2 * t),
                ph, pl);
        const float* k0 = K + (8 * ks + 2 * t) * WP + g;
#pragma unroll
        for (int nf = 0; nf < 8; ++nf) {
          // columns past R are computed from column 0 and not stored
          const int d = d0 + 8 * nf < R ? d0 + 8 * nf : 0;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(k0[d], bh0, bl0);
          split_tf32(k0[WP + d], bh1, bl1);
          mma3(o[nf], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();             // stage st and the weights consumed
  }
  if (sk == 0) {
    Mx[sr] = m_run;
    Lx[sr] = l_run;
  }
  __syncthreads();

  const int PW = R + 4;                         // a part row: acc, m, l
  const size_t prow = ((size_t)b * ntiles + rt) * RT;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = g + 8 * h2;
    if (r >= nr) continue;
    const float l = fmaxf(Lx[r], 1e-20f);
    float* dst = nlive == 1 ? merged + (row0 + r) * R
                            : part + ((prow + r) * nsplit + z) * PW;
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
      const int d = d0 + 8 * nf + 2 * t;
      if (d >= R) break;
      float2 v = make_float2(o[nf][2 * h2], o[nf][2 * h2 + 1]);
      if (nlive == 1) {
        v.x /= l;
        v.y /= l;
        *reinterpret_cast<float2*>(dst + d) = v;
      } else {
        __stcg(reinterpret_cast<float2*>(dst + d), v);
      }
    }
  }
  if (nlive == 1) return;
  if (tid < nr) {
    float* dst = part + ((prow + tid) * nsplit + z) * PW;
    __stcg(dst + R, Mx[tid]);
    __stcg(dst + R + 1, Lx[tid]);
  }

  // the last part of the row tile to arrive merges them, in part order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + (size_t)b * ntiles + rt;
    last = atomicAdd(ctr, 1) == nlive - 1;
    if (last) *ctr = 0;                         // every part has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each part's (m, l), then its weight exp(m_k - m) per row, in the
  // stages' memory (the host checks that 2 * RT * nsplit floats fit)
  float* Wk = Ks;                               // [RT][nlive]
  float* Lk = Ks + RT * nlive;                  // [RT][nlive]
  for (int e = tid; e < nr * nlive; e += WALK_THREADS) {
    const int r = e / nlive, k = e - r * nlive;
    const float* src = part + ((prow + r) * nsplit + k) * PW;
    Wk[e] = __ldcg(src + R);
    Lk[e] = __ldcg(src + R + 1);
  }
  __syncthreads();
  if (tid < nr) {
    float m = NEG_INF;
    for (int k = 0; k < nlive; ++k) m = fmaxf(m, Wk[tid * nlive + k]);
    float l = 0.f;
    for (int k = 0; k < nlive; ++k) {
      const float a = expf(Wk[tid * nlive + k] - m);
      Wk[tid * nlive + k] = a;
      l += Lk[tid * nlive + k] * a;
    }
    Lx[tid] = fmaxf(l, 1e-20f);
  }
  __syncthreads();
  // thread tid merges (row, 16-byte chunk) pairs tid + 256 i, each over
  // the parts in part order, MK parts' loads in flight at a time
  constexpr int MP = RT * MAX_R / 4 / WALK_THREADS;  // pairs a thread
  constexpr int MK = 2;
  float4 acc[MP];
#pragma unroll
  for (int i = 0; i < MP; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nlive; k0 += MK) {
    float4 v[MK][MP];
#pragma unroll
    for (int u = 0; u < MK; ++u)
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        const int e = tid + WALK_THREADS * i, r = e / RCH, c = e - r * RCH;
        const int k = min(k0 + u, nlive - 1);
        v[u][i] = r < nr ? __ldcg(reinterpret_cast<const float4*>(
                               part + ((prow + r) * nsplit + k) * PW + 4 * c))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < MK; ++u) {
      if (k0 + u >= nlive) break;
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        const int r = min((tid + WALK_THREADS * i) / RCH, nr - 1);
        const float a = Wk[r * nlive + k0 + u];
        acc[i].x += v[u][i].x * a; acc[i].y += v[u][i].y * a;
        acc[i].z += v[u][i].z * a; acc[i].w += v[u][i].w * a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    const int e = tid + WALK_THREADS * i, r = e / RCH, c = e - r * RCH;
    if (r >= nr) continue;
    const float l = Lx[r];
    *reinterpret_cast<float4*>(merged + (row0 + r) * R + 4 * c) =
        make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l, acc[i].w / l);
  }
}

// ------------------------------------------------------ the tiled walk
//
// Prefill chunks (C * H > 16 query rows per batch row) at R = 512,
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

// tiled_walk != 0 takes the prefill route (R = 512, Dr = 64): the 3xTF32
// GEMMs and the tiled walk; it needs neither `part` nor `counters`.
// Otherwise the decode route: the small-M GEMMs and the split walk over
// `nsplit` parts (at least decode_parts(MB * BS, ring)), R <= 512, with
// `part` (B, row tiles * RT, nsplit, R + 4) floats and `counters`
// (B * row tiles) ints, 0 between launches, when nsplit > 1.  Rows move
// 16 bytes at a time: nope, Dr, Dv and R are multiples of 4 and q, the
// pools, k_up, v_up, q_lat and merged 16-byte aligned.
extern "C" int pm_paged_attention_mla(
    const void* q, const void* ckv, const void* krope, const void* table,
    const void* kv_len, const void* q_off, const void* newest,
    const void* k_up, const void* v_up, void* q_lat, void* part,
    void* counters, void* merged, void* out, int B, int C, int H, int R,
    int Dr, int nope, int Dv, int BS, int MB, int causal, int window,
    int ring, int nsplit, int tiled_walk, float scale, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  const auto a16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  if (H <= 0 || R <= 0 || Dr <= 0 || nope <= 0 || Dv <= 0 || BS <= 0 ||
      MB <= 0 || nsplit <= 0 || (ring && newest == nullptr) || R % 4 ||
      Dr % 4 || nope % 4 || Dv % 4 || !a16(ckv) || !a16(krope) || !a16(q) ||
      !a16(k_up) || !a16(v_up) || !a16(q_lat) || !a16(merged))
    return (int)cudaErrorInvalidValue;
  if (tiled_walk ? R != tiled::R || Dr != tiled::DR || nsplit != 1
                 : R > MAX_R || R % 8 || (R + Dr) % 8 ||
                       R + Dr > 8 * KSW * WALK_WARPS ||
                       nsplit < decode_parts(MB * BS, ring) ||
                       2 * RT * nsplit > STAGES * DK * (R + Dr + 4) ||
                       (nsplit > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * C, rows = C * H, Dq = nope + Dr;
  cudaError_t err;

  if (tiled_walk) {
    // 1. absorb k_up into the query: q_lat (B*C, H, R)
    const Strides s1 = {Dq, (long long)H * Dq, 1, nope, 1,
                        (long long)H * nope, R, (long long)H * R, 1};
    const dim3 g1((R + GT - 1) / GT, (M + GT - 1) / GT, H);
    tf32x3_gemm_kernel<<<g1, GTHREADS, 0, st>>>(
        (const float*)q, (const float*)k_up, (float*)q_lat, M, R, nope, s1,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // 2. the tiled walk, normalised
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
    // 3. decompress V after the walk: out (B*C, H, Dv)
    const Strides s3 = {R, (long long)H * R, 1, Dv, (long long)H * Dv, 1,
                        Dv, (long long)H * Dv, 1};
    const dim3 g3((Dv + GT - 1) / GT, (M + GT - 1) / GT, H);
    tf32x3_gemm_kernel<<<g3, GTHREADS, 0, st>>>(
        (const float*)merged, (const float*)v_up, (float*)out, M, Dv, R, s3,
        1.f);
    return (int)cudaGetLastError();
  }

  const int mz = (M + GM - 1) / GM;
  // 1. absorb k_up into the query
  const size_t sm1 = sizeof(float) * (32 * (size_t)(nope + 4) + GM * nope);
  static size_t granted1[dyn_smem::MAX_DEVICES] = {};
  err = dyn_smem::opt_in(absorb_small_kernel, sm1, granted1);
  if (err != cudaSuccess) return (int)err;
  absorb_small_kernel<<<dim3((R + 31) / 32, H, mz), 256, sm1, st>>>(
      (const float*)q, (const float*)k_up, (float*)q_lat, M, H, R, nope, Dq,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 2. the split walk, merged by the last part of each row tile
  const size_t sm2 = walk_smem(R + Dr);
  static size_t granted2[dyn_smem::MAX_DEVICES] = {};
  err = dyn_smem::opt_in(mla_decode_kernel, sm2, granted2);
  if (err != cudaSuccess) return (int)err;
  mla_decode_kernel<<<dim3(nsplit, (rows + RT - 1) / RT, B), WALK_THREADS,
                      sm2, st>>>(
      (const float*)q, (const float*)q_lat, (const float*)ckv,
      (const float*)krope, (const int32_t*)table, (const int32_t*)kv_len,
      (const int32_t*)q_off, (const int32_t*)newest, (float*)merged,
      (float*)part, (int*)counters, C, H, R, Dr, nope, BS, MB, causal,
      window, ring, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 3. decompress V
  const size_t sm3 = sizeof(float) * ((size_t)GM * R + 32 * GM * 8);
  static size_t granted3[dyn_smem::MAX_DEVICES] = {};
  err = dyn_smem::opt_in(v_up_small_kernel, sm3, granted3);
  if (err != cudaSuccess) return (int)err;
  v_up_small_kernel<<<dim3((Dv + 7) / 8, H, mz), 256, sm3, st>>>(
      (const float*)merged, (const float*)v_up, (float*)out, M, H, R, Dv);
  return (int)cudaGetLastError();
}
