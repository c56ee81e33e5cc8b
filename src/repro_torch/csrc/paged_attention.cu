// Paged GQA attention: walk each row's block table over the K/V pools
// with an online softmax, causal and window masks, per-row kv_len and
// q_offset — over a paged table or a sliding-window ring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention -> _paged_attn_kernel) in its layout="gqa" variants,
// ring=False and ring=True.  Shapes: q (B, C, H, Dh); k/v pools
// (NB, BS, Hkv, Dh); block_table (B, MB); kv_len, q_offset, newest
// (B,); out (B, C, H, Dh), all float32 / int32.  Semantics as the
// Pallas body: q is scaled by Dh^-0.5 before the dot; slot s = i*BS + j
// holds key position kpos = s, or on a ring
// kpos = newest[b] - ((newest[b] - s) mod (MB*BS)) with a FLOOR modulo
// (newest - s is negative for slots the ring has not reached; those
// come out negative: never written); a key is valid iff 0 <= kpos <
// kv_len[b], and (causal) q_offset[b] + c >= kpos, and (window > 0)
// q_offset[b] + c - kpos < window; masked scores are -1e30 and their
// weights are exactly 0; a row with l = 0 writes zeros.
//
// Bound on this card: memory — the K and V bytes a row's walk gathers,
// min(kv_len, MB*BS) * Hkv * Dh * 2 * 4 per batch row.
//
// Design: the TPU walked the table as a sequential grid axis with the
// (m, l, acc) state in VMEM scratch.  Here one block owns one
// (batch row, kv head, tile of QT query rows) and its WARPS split the
// row's logical blocks between them: warp w walks blocks w, w + NW, ...
// with a private online-softmax state per query row, and the NW partial
// states are merged at the end (the split-K of flash decoding, inside
// one block).  That keeps all NW warps busy at decode, where a tile
// holds a single query row.  On a paged table the walk stops at the
// last block any query of the tile can see (kv_len, and the causal
// bound).  On a ring positions are not monotone in the block index, so
// the walk covers the whole table width, and a warp first asks of each
// block whether any of its slots is visible to any query of the tile
// (one ballot) and skips it when none is — a block whose every weight
// would be 0.  The two walks are two instantiations of one template.
// Each warp stages its K/V block (BS x Dh floats of this head) in its
// own slice of shared memory — K with a padded row so lane j reading
// key j hits distinct banks — so the walk needs no block-wide barrier;
// it loads 16 bytes a lane, four loads in flight, so the walk does not
// wait on memory latency one float at a time.
// At Dh = 128 a block uses (16*128 + 8*16*257 + 8*16*130) * 4 = 206 KB
// of the 227 KB of shared memory: one block per SM.  The V width is
// Dh.  Per query row, lane j scores
// key j, the block max and sum come from warp shuffles, and lane d
// updates output dims d, d+32, ... with the weights broadcast by
// shuffle.  All softmax state is float32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 16;          // query rows (c, g) per block
constexpr int NW = 8;           // warps per block, each walking 1/NW of the keys
constexpr float NEG_INF = -1e30f;

// Absolute position of table slot s: s itself, or on a ring of cap
// slots the newest position congruent to s (floor modulo; negative =
// never written).
template <bool RING>
__device__ __forceinline__ int key_pos(int s, int newest, int cap) {
  if (!RING) return s;
  int d = (newest - s) % cap;
  if (d < 0) d += cap;
  return newest - d;
}

// RING = false compiles the paged walk alone; RING = true the ring's.
template <bool RING>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ kpool,
    const float* __restrict__ vpool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    const int32_t* __restrict__ newest_pos, float* __restrict__ out, int C,
    int H, int Hkv, int Dh, int BS, int MB, int causal, int window,
    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = H / Hkv, R = C * G;
  const int r0 = blockIdx.z * QT, nr = min(QT, R - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldk = Dh + 1;
  float* Qs = smem;                               // [QT][Dh], pre-scaled
  float* Ks = Qs + QT * Dh + warp * BS * (2 * Dh + 1);   // this warp's
  float* Vs = Ks + BS * ldk;                             // K/V block
  float* St = smem + QT * Dh + NW * BS * (2 * Dh + 1);
  float* Acc = St + warp * QT * (Dh + 2);         // this warp's [QT][Dh]
  float* Ms = Acc + QT * Dh;                      // [QT]
  float* Ls = Ms + QT;                            // [QT]

  for (int e = tid; e < nr * Dh; e += blockDim.x) {
    const int r = e / Dh, d = e % Dh, row = r0 + r;
    const int c = row / G, h = kvh * G + row % G;
    Qs[e] = q[(((size_t)b * C + c) * H + h) * Dh + d] * scale;
  }
  for (int e = lane; e < nr * Dh; e += 32) Acc[e] = 0.f;
  for (int r = lane; r < nr; r += 32) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.f;
  }
  __syncthreads();                                // Qs ready

  const int len = kv_len[b], qoff = q_off[b];
  const int newest = RING ? newest_pos[b] : 0, cap = MB * BS;
  const int qlo = qoff + r0 / G, qhi = qoff + (r0 + nr - 1) / G;
  int nblk = MB;                       // a ring walks the whole table
  if (!RING) {
    int kmax = len;                    // keys [0, kmax) can be visible
    if (causal) kmax = min(kmax, qhi + 1);
    nblk = kmax > 0 ? min(MB, (kmax + BS - 1) / BS) : 0;
  }

  for (int i = warp; i < nblk; i += NW) {         // warp-uniform
    if (RING) {
      bool any = false;                // a slot some query can see?
      for (int j0 = 0; j0 < BS; j0 += 32) {
        const int j = j0 + lane;
        const int kpos = key_pos<RING>(i * BS + j, newest, cap);
        bool vis = j < BS && kpos >= 0 && kpos < len;
        if (causal) vis = vis && kpos <= qhi;
        if (window > 0) vis = vis && qlo - kpos < window;
        any = any || vis;
      }
      if (!__any_sync(0xffffffffu, any)) continue;
    }
    const size_t phys = (size_t)table[(size_t)b * MB + i];
    __syncwarp();                                 // previous block consumed
#pragma unroll 4
    for (int e = 4 * lane; e < BS * Dh; e += 128) {   // 16-byte loads
      const int j = e / Dh, d = e % Dh;
      const size_t src = ((phys * BS + j) * Hkv + kvh) * Dh + d;
      const float4 k4 = *reinterpret_cast<const float4*>(kpool + src);
      const float4 v4 = *reinterpret_cast<const float4*>(vpool + src);
      float* kd = Ks + j * ldk + d;
      kd[0] = k4.x;
      kd[1] = k4.y;
      kd[2] = k4.z;
      kd[3] = k4.w;
      *reinterpret_cast<float4*>(Vs + e) = v4;
    }
    __syncwarp();
    for (int r = 0; r < nr; ++r) {
      const int qpos = qoff + (r0 + r) / G;
      const float* qr = Qs + r * Dh;
      float m_prev = Ms[r], l_prev = Ls[r];
      for (int j0 = 0; j0 < BS; j0 += 32) {
        const int j = j0 + lane;
        const int kpos = key_pos<RING>(i * BS + j, newest, cap);
        bool valid = j < BS && (!RING || kpos >= 0) && kpos < len;
        if (causal) valid = valid && qpos >= kpos;
        if (window > 0) valid = valid && qpos - kpos < window;
        float s = NEG_INF;
        if (valid) {
          const float* kr = Ks + j * ldk;
          float dot = 0.f;
          for (int d = 0; d < Dh; ++d) dot += qr[d] * kr[d];
          s = dot;
        }
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_prev, mx);
        const float p = valid ? expf(s - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        const float a = expf(m_prev - m_new);
        l_prev = l_prev * a + psum;
        const int jn = min(32, BS - j0);
        for (int d0 = 0; d0 < Dh; d0 += 32) {     // warp-uniform
          const int d = d0 + lane;
          float o = d < Dh ? Acc[r * Dh + d] * a : 0.f;
          for (int jj = 0; jj < jn; ++jj) {
            const float pj = __shfl_sync(0xffffffffu, p, jj);
            if (d < Dh) o += pj * Vs[(j0 + jj) * Dh + d];
          }
          if (d < Dh) Acc[r * Dh + d] = o;
        }
        m_prev = m_new;
      }
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_prev;
        Ls[r] = l_prev;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // merge the NW partial states of each query row; a row no warp saw a
  // key for keeps m = -1e30, l = 0, acc = 0 in every slice and writes 0
  for (int e = tid; e < nr * Dh; e += blockDim.x) {
    const int r = e / Dh, d = e % Dh, row = r0 + r;
    float m = NEG_INF;
    for (int w = 0; w < NW; ++w) m = fmaxf(m, St[w * QT * (Dh + 2) + QT * Dh + r]);
    float l = 0.f, o = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float* S = St + w * QT * (Dh + 2);
      const float a = expf(S[QT * Dh + r] - m);
      l += S[QT * Dh + QT + r] * a;
      o += S[e] * a;
    }
    const int c = row / G, h = kvh * G + row % G;
    out[(((size_t)b * C + c) * H + h) * Dh + d] = o / fmaxf(l, 1e-20f);
  }
}

}  // namespace

extern "C" int pa_paged_attention(const void* q, const void* kpool,
                                  const void* vpool, const void* table,
                                  const void* kv_len, const void* q_off,
                                  const void* newest, void* out, int B,
                                  int C, int H, int Hkv, int Dh, int BS,
                                  int MB, int causal, int window, int ring,
                                  float scale, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  // the walk stages K/V rows with 16-byte loads: rows of Dh floats start
  // 16-byte aligned in the pools and, with BS % 4 == 0, in every warp's
  // shared-memory slice
  if (Hkv <= 0 || H % Hkv != 0 || Dh <= 0 || BS <= 0 || MB <= 0 ||
      (ring && newest == nullptr) || Dh % 4 || BS % 4 ||
      (uintptr_t)kpool % 16 || (uintptr_t)vpool % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)QT * Dh + (size_t)NW * BS * (2 * Dh + 1) +
                       (size_t)NW * QT * (Dh + 2));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t opted_in[2] = {48 * 1024, 48 * 1024};   // per variant
  const auto kernel = ring ? paged_attention_kernel<true>
                           : paged_attention_kernel<false>;
  if (smem > opted_in[ring != 0]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in[ring != 0] = smem;
  }
  const int R = C * (H / Hkv);
  const dim3 grid(B, Hkv, (R + QT - 1) / QT);
  kernel<<<grid, NW * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)kpool, (const float*)vpool,
      (const int32_t*)table, (const int32_t*)kv_len, (const int32_t*)q_off,
      (const int32_t*)newest, (float*)out, C, H, Hkv, Dh, BS, MB, causal,
      window, scale);
  return (int)cudaGetLastError();
}
