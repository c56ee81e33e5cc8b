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
// the float32 operations of the absorbed form below.
//
// Design: the TPU kept k_up and v_up resident in VMEM and decompressed
// every gathered block per head.  Here the two 4 MB matrices cannot sit
// in a block's 227 KB of shared memory, so the kernel computes the same
// function in the absorbed order, in four launches on one stream:
//   1. q_lat[b, c, h, :] = scale * q_nope[b, c, h] . k_up[:, h]^T  (R wide)
//      — a batched tiled GEMM, one batch per head;
//   2. the walk: a block owns RT = 16 query rows (c, h) of one batch row
//      and one part of its table (the walk is split into `nsplit` parts
//      when B * tiles would leave the card idle, as at decode).  It
//      stages each latent block (BS x (R + Dr) floats, 36.9 KB at
//      BS = 16; 16-byte loads) in shared memory ONCE for all 16 heads,
//      scores q_lat . c_kv + q_rope . k_rope, and keeps an online
//      softmax with an R-wide accumulator of the weighted LATENTS per
//      query row;
//      skipped are blocks no query of the tile can see (kv_len, causal,
//      window, never-written ring slots);
//   3. merge the parts' (m, l, acc) and divide by l;
//   4. out[b, c, h, :] = acc[b, c, h] . v_up[:, h]  — the batched GEMM
//      again.
// Rows of shared memory are padded by one float so lanes reading
// neighbouring keys hit distinct banks.  All arithmetic is float32 on
// the CUDA cores; the summation order differs from decompress-then-dot.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RT = 16;            // query rows (c, h) per walk block
constexpr int WALK_THREADS = 256;
constexpr int GT = 64;            // GEMM output tile (GT x GT)
constexpr int GK = 16;            // GEMM K tile
constexpr float NEG_INF = -1e30f;

// Element strides of a batched GEMM C[z] = alpha * A[z] B[z].
struct Strides {
  long long a_z, a_m, a_k, b_z, b_k, b_n, c_z, c_m, c_n;
};

// One GT x GT tile of C[z] per block of 256 threads, 4 x 4 outputs per
// thread, K in GK-deep shared-memory tiles; every edge is guarded.  The
// tile loads walk the operand's unit-stride axis with neighbouring
// threads.
__global__ void batched_sgemm_kernel(const float* __restrict__ A,
                                     const float* __restrict__ Bm,
                                     float* __restrict__ Cm, int M, int N,
                                     int K, Strides st, float alpha) {
  __shared__ float As[GK][GT + 4];
  __shared__ float Bs[GK][GT + 4];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * GT, n0 = blockIdx.x * GT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* a = A + z * st.a_z;
  const float* bm = Bm + z * st.b_z;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GK) {
    for (int e = threadIdx.x; e < GK * GT; e += 256) {
      int kk, mm;
      if (st.a_k == 1) { kk = e % GK; mm = e / GK; }
      else { kk = e / GT; mm = e % GT; }
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? a[m * st.a_m + k * st.a_k] : 0.f;
      int kb, nn;
      if (st.b_k == 1) { kb = e % GK; nn = e / GK; }
      else { kb = e / GT; nn = e % GT; }
      const int n = n0 + nn, k2 = k0 + kb;
      Bs[kb][nn] = (n < N && k2 < K) ? bm[k2 * st.b_k + n * st.b_n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
  float* c = Cm + z * st.c_z;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) c[m * st.c_m + n * st.c_n] = alpha * acc[i][j];
    }
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

}  // namespace

extern "C" int pm_paged_attention_mla(
    const void* q, const void* ckv, const void* krope, const void* table,
    const void* kv_len, const void* q_off, const void* newest,
    const void* k_up, const void* v_up, void* q_lat, void* part,
    void* merged, void* out, int B, int C, int H, int R, int Dr, int nope,
    int Dv, int BS, int MB, int causal, int window, int ring, int nsplit,
    float scale, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  // the walk stages latent and rope rows with 16-byte loads
  if (H <= 0 || R <= 0 || Dr <= 0 || nope <= 0 || Dv <= 0 || BS <= 0 ||
      MB <= 0 || nsplit <= 0 || (ring && newest == nullptr) || R % 4 ||
      Dr % 4 || (uintptr_t)ckv % 16 || (uintptr_t)krope % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = B * C, rows = C * H, Dq = nope + Dr;

  // 1. absorb k_up into the query: q_lat (B*C, H, R)
  const Strides s1 = {Dq, (long long)H * Dq, 1, nope, 1, (long long)H * nope,
                      R, (long long)H * R, 1};
  const dim3 g1((R + GT - 1) / GT, (M + GT - 1) / GT, H);
  batched_sgemm_kernel<<<g1, 256, 0, st>>>(
      (const float*)q, (const float*)k_up, (float*)q_lat, M, R, nope, s1,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2. the walk over the latent blocks
  const size_t ldw = (size_t)R + Dr + 1;
  const size_t smem = sizeof(float) * ((size_t)RT * ldw + (size_t)BS * ldw +
                                       (size_t)RT * R + (size_t)RT * BS +
                                       3 * RT);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t opted_in = 48 * 1024;   // dynamic smem allowed so far
  if (smem > opted_in) {
    err = cudaFuncSetAttribute(mla_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const dim3 g2(B, (rows + RT - 1) / RT, nsplit);
  mla_walk_kernel<<<g2, WALK_THREADS, smem, st>>>(
      (const float*)q, (const float*)q_lat, (const float*)ckv,
      (const float*)krope, (const int32_t*)table, (const int32_t*)kv_len,
      (const int32_t*)q_off, (const int32_t*)newest, (float*)part, B, C, H,
      R, Dr, nope, BS, MB, causal, window, ring, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 3. merge the parts
  mla_merge_kernel<<<B * rows, 128, 0, st>>>((const float*)part,
                                             (float*)merged, B * rows, R,
                                             nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 4. decompress V after the walk: out (B*C, H, Dv)
  const Strides s4 = {R, (long long)H * R, 1, Dv, (long long)H * Dv, 1,
                      Dv, (long long)H * Dv, 1};
  const dim3 g4((Dv + GT - 1) / GT, (M + GT - 1) / GT, H);
  batched_sgemm_kernel<<<g4, 256, 0, st>>>(
      (const float*)merged, (const float*)v_up, (float*)out, M, Dv, R, s4,
      1.f);
  return (int)cudaGetLastError();
}
