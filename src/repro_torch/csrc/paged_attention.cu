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
// Bound on this card: at decode memory — the K and V bytes a row's walk
// gathers, min(kv_len, MB*BS) * Hkv * Dh * 2 * 4 per batch row; in a
// prefill chunk float32 operations — 4 * Dh per visible (query, key)
// pair and head, at 67 TFLOP/s outside the tensor cores (mixtral's
// C = 128 chunk over its 4224-slot ring: 0.67 ms).
//
// Two paths, chosen by the query rows R = C * G of a (batch row, kv
// head): R <= QT (decode) takes the split walk below; R > QT (prefill
// chunks, Dh = 64 or 128) the tiled path further down.  Other head
// widths take the split walk at any R.
//
// Decode design (flash decoding).  The TPU walked the table as a
// sequential grid axis with the (m, l, acc) state in VMEM scratch; at
// decode that is one long serial walk per (batch row, kv head), too few
// of them to fill 132 SMs.  Here the walk runs in POSITION space: the
// keys a tile of DR query rows can see are the positions [lo, hi]
// (kv_len, the causal bound, the window, and on a ring the capacity
// behind `newest`), each at table slot p (paged) or p mod (MB*BS)
// (ring), so a ring walks only its visible arc.  Positions are cut into
// parts of PART_KEYS (a constant): part k holds [k*PART_KEYS,
// (k+1)*PART_KEYS), and one block walks one part of one (batch row, kv
// head, row tile).  The grid has `nsplit` blocks per row tile, sized on
// the host from the table width alone (kernels/paged_attention
// .decode_parts); a block past its row's last part exits at once.  A
// row's parts, the tiles inside a part and the merge order depend only
// on that row's own positions: a row sums in the same order whatever the
// batch, the table width or the other rows hold.
// Inside a block, 4 warps stage DK-key tiles of K and V into shared
// memory with cp.async, double-buffered, so the next tile's bytes are
// in flight while one is scored; registers are capped for 3 blocks an
// SM (at Dh = 128: 168 registers, 64 KB of shared memory a block),
// which measured faster than 3 stages at 2 blocks an SM, or 4 blocks.
// Eight lanes share a key: lane i holds float4 chunks i, i + 8, ... of
// the key (and of the DR query rows, in registers), so a warp scores
// four keys at once with every lane busy, and a key's dot is three
// shuffles.  Each 8-lane group keeps its own
// online-softmax state and output accumulator in registers (its dims,
// DR rows) over the keys it was given; the 16 groups merge in group
// order through shared memory at the end of the part.  A row that
// needs one part writes its output there; otherwise each part stores
// (acc, m, l) to a scratch, bumps its row tile's counter, and the last
// part to arrive merges the parts in part order, divides, writes the
// output and leaves the counter at 0 for the next launch (the split-K
// of csrc/bnn_gemm.cuh, one launch).  All softmax state is float32;
// masked keys weigh exactly 0 and a row that sees no key writes zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int QT = 16;          // query rows (c, g) a decode tile may hold
constexpr int DR = 4;           // query rows per decode block
constexpr int PART_KEYS = 256;  // positions per part of the decode walk
constexpr int DK = 32;          // keys per staged K/V tile
constexpr int DSTAGES = 2;      // K/V tile stages: one loads, one is scored
constexpr int DTHREADS = 128;   // 4 warps = 16 groups of 8 lanes
constexpr int DGROUPS = DTHREADS / 8;
constexpr int KPG = DK / DGROUPS;    // keys of a tile per group
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Parts of PART_KEYS positions the grid must give a row tile: every
// part its visible positions can touch.  A paged row sees positions
// inside [0, cap); a ring row at most cap consecutive ones, which may
// start mid-part.  Mirrored by kernels/paged_attention.decode_parts.
inline int decode_parts(int cap, int ring) {
  return ring ? (cap - 1 + PART_KEYS - 1) / PART_KEYS + 1
              : (cap + PART_KEYS - 1) / PART_KEYS;
}

// NC float4 chunks of a key per lane (Dh <= 32 * NC).  Grid (nsplit,
// Hkv * row tiles, B); `part` (B, Hkv, row tiles * DR, nsplit, Dh + 2)
// floats and `counters` (B * Hkv * row tiles) ints, 0 between launches;
// both unused when nsplit == 1.
template <int NC>
__global__ __launch_bounds__(DTHREADS, 3) void paged_attention_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ kpool,
    const float* __restrict__ vpool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    const int32_t* __restrict__ newest_pos, float* __restrict__ out,
    float* __restrict__ part, int* __restrict__ counters, int C, int H,
    int Hkv, int Dh, int BS, int MB, int causal, int window, int ring,
    int nsplit, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.x, kvh = blockIdx.y % Hkv;
  const int rt = blockIdx.y / Hkv, ntiles = gridDim.y / Hkv, b = blockIdx.z;
  const int G = H / Hkv, R = C * G, r0 = rt * DR, nr = min(DR, R - r0);
  const int CH = Dh / 4, cap = MB * BS;
  const int len = kv_len[b], qoff = q_off[b];
  const int qlo = qoff + r0 / G, qhi = qoff + (r0 + nr - 1) / G;

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

  float* Ks = smem;                              // [DSTAGES][DK][Dh]
  float* Vs = Ks + DSTAGES * DK * Dh;            // [DSTAGES][DK][Dh]
  long long* Off = reinterpret_cast<long long*>(Vs + DSTAGES * DK * Dh);
  const int tid = threadIdx.x, lane = tid & 31;
  const int grp = tid >> 3, lig = lane & 7;      // key group, lane in it

  float4 qv[DR][NC];
  int qpos[DR];
#pragma unroll
  for (int r = 0; r < DR; ++r) {
    const int row = r0 + min(r, nr - 1);        // rows past R: unused
    qpos[r] = qoff + row / G;
    const float* qr = q + (((size_t)b * C + row / G) * H + kvh * G + row % G)
        * Dh;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int ch = lig + 8 * i;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr && ch < CH) {
        v = *reinterpret_cast<const float4*>(qr + 4 * ch);
        v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
      }
      qv[r][i] = v;
    }
  }

  // tiles of DK positions, aligned to DK, covering [ps, pe]
  const int ts0 = ps / DK * DK;
  const int ntile = ps <= pe ? (pe - ts0) / DK + 1 : 0;
  // the pool offset of each key of tile t (-1 outside [ps, pe])
  auto offsets = [&](int st, int t) {
    if (tid < DK) {
      const int p = ts0 + t * DK + tid;
      long long off = -1;
      if (p >= ps && p <= pe) {
        const int slot = ring ? p % cap : p;
        const long long phys = table[(size_t)b * MB + slot / BS];
        off = ((phys * BS + slot % BS) * Hkv + kvh) * (long long)Dh;
      }
      Off[st * DK + tid] = off;
    }
  };
  // this thread's (key, chunk) copies: e = tid + DTHREADS * k
  const int j0 = tid / CH, c0 = tid % CH;
  const int dj = DTHREADS / CH, dc = DTHREADS % CH;
  auto load = [&](int st) {
    for (int j = j0, c = c0; j < DK;) {
      const long long off = Off[st * DK + j];
      float* kd = Ks + (st * DK + j) * Dh + 4 * c;
      float* vd = Vs + (st * DK + j) * Dh + 4 * c;
      if (off >= 0) {
        cp_async16(kd, kpool + off + 4 * c, 16);
        cp_async16(vd, vpool + off + 4 * c, 16);
      } else {                       // outside the part: zeros, masked
        cp_async16(kd, kpool, 0);
        cp_async16(vd, vpool, 0);
      }
      j += dj;
      c += dc;
      if (c >= CH) {
        c -= CH;
        ++j;
      }
    }
  };

  float4 acc[DR][NC];
  float m_i[DR], l_i[DR];
#pragma unroll
  for (int r = 0; r < DR; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

#pragma unroll
  for (int t = 0; t < DSTAGES - 1; ++t)
    if (t < ntile) offsets(t, t);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < DSTAGES - 1; ++t) {
    if (t < ntile) load(t);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int t = 0; t < ntile; ++t) {                // block-uniform
    const int st = t % DSTAGES, tn = t + DSTAGES - 1;
    if (tn < ntile) offsets(tn % DSTAGES, tn);
    __syncthreads();             // offsets of tn ready; tile t-1 consumed
    if (tn < ntile) load(tn % DSTAGES);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(DSTAGES - 1));
    __syncthreads();             // tile t in shared memory

    float s[KPG][DR];
    bool valid[KPG][DR];
#pragma unroll
    for (int kk = 0; kk < KPG; ++kk) {
      const int j = grp + DGROUPS * kk, p = ts0 + t * DK + j;
      const float* kr = Ks + (st * DK + j) * Dh;
      float4 kf4[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int ch = lig + 8 * i;
        kf4[i] = ch < CH ? *reinterpret_cast<const float4*>(kr + 4 * ch)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const bool in = p >= ps && p <= pe;
#pragma unroll
      for (int r = 0; r < DR; ++r) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < NC; ++i) d += dot4(qv[r][i], kf4[i]);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        bool v = in && r < nr;
        if (causal) v = v && p <= qpos[r];
        if (window > 0) v = v && qpos[r] - p < window;
        s[kk][r] = d;
        valid[kk][r] = v;
      }
    }
    float pw[KPG][DR];
#pragma unroll
    for (int r = 0; r < DR; ++r) {
      float m_new = m_i[r];
#pragma unroll
      for (int kk = 0; kk < KPG; ++kk)
        if (valid[kk][r]) m_new = fmaxf(m_new, s[kk][r]);
      const float a = expf(m_i[r] - m_new);
      float l = l_i[r] * a;
#pragma unroll
      for (int kk = 0; kk < KPG; ++kk) {
        pw[kk][r] = valid[kk][r] ? expf(s[kk][r] - m_new) : 0.f;
        l += pw[kk][r];
      }
      l_i[r] = l;
      m_i[r] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[r][i].x *= a; acc[r][i].y *= a;
        acc[r][i].z *= a; acc[r][i].w *= a;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KPG; ++kk) {
      const float* vr = Vs + (st * DK + grp + DGROUPS * kk) * Dh;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int ch = lig + 8 * i;
        if (ch >= CH) continue;
        const float4 v = *reinterpret_cast<const float4*>(vr + 4 * ch);
#pragma unroll
        for (int r = 0; r < DR; ++r) {
          const float w = pw[kk][r];
          acc[r][i].x += w * v.x; acc[r][i].y += w * v.y;
          acc[r][i].z += w * v.z; acc[r][i].w += w * v.w;
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();                             // the stages are free

  // the 16 groups' states, merged in group order
  float* Ag = smem;                            // [DGROUPS][DR][Dh]
  float* Mg = Ag + DGROUPS * DR * Dh;          // [DGROUPS][DR]
  float* Lg = Mg + DGROUPS * DR;               // [DGROUPS][DR]
#pragma unroll
  for (int r = 0; r < DR; ++r) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int ch = lig + 8 * i;
      if (ch < CH)
        *reinterpret_cast<float4*>(Ag + (grp * DR + r) * Dh + 4 * ch) =
            acc[r][i];
    }
    if (lig == 0) {
      Mg[grp * DR + r] = m_i[r];
      Lg[grp * DR + r] = l_i[r];
    }
  }
  __syncthreads();
  const size_t prow = ((size_t)b * Hkv + kvh) * ntiles * DR + r0;
  const int W = Dh + 2;                        // a part row: acc, m, l
  for (int e = tid; e < nr * Dh; e += DTHREADS) {
    const int r = e / Dh, d = e % Dh;
    float m = NEG_INF;
    for (int g = 0; g < DGROUPS; ++g) m = fmaxf(m, Mg[g * DR + r]);
    float l = 0.f, o = 0.f;
    for (int g = 0; g < DGROUPS; ++g) {
      const float a = expf(Mg[g * DR + r] - m);
      l += Lg[g * DR + r] * a;
      o += Ag[(g * DR + r) * Dh + d] * a;
    }
    if (nlive == 1) {
      const int row = r0 + r;
      out[(((size_t)b * C + row / G) * H + kvh * G + row % G) * Dh + d] =
          o / fmaxf(l, 1e-20f);
    } else {
      float* dst = part + ((prow + r) * nsplit + z) * W;
      __stcg(dst + d, o);
      if (d == 0) {
        __stcg(dst + Dh, m);
        __stcg(dst + Dh + 1, l);
      }
    }
  }
  if (nlive == 1) return;

  // the last part of the row tile to arrive merges them, in part order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + ((size_t)b * Hkv + kvh) * ntiles + rt;
    last = atomicAdd(ctr, 1) == nlive - 1;
    if (last) *ctr = 0;                        // every part has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < nr * Dh; e += DTHREADS) {
    const int r = e / Dh, d = e % Dh;
    const float* src = part + (prow + r) * nsplit * W;
    float m = NEG_INF;
    for (int k = 0; k < nlive; ++k) m = fmaxf(m, __ldcg(src + k * W + Dh));
    float l = 0.f, o = 0.f;
    for (int k = 0; k < nlive; ++k) {
      const float a = expf(__ldcg(src + k * W + Dh) - m);
      l += __ldcg(src + k * W + Dh + 1) * a;
      o += __ldcg(src + k * W + d) * a;
    }
    const int row = r0 + r;
    out[(((size_t)b * C + row / G) * H + kvh * G + row % G) * Dh + d] =
        o / fmaxf(l, 1e-20f);
  }
}

template <int NC>
cudaError_t launch_decode(const void* q, const void* kpool,
                          const void* vpool, const void* table,
                          const void* kv_len, const void* q_off,
                          const void* newest, void* out, void* part,
                          void* counters, int B, int C, int H, int Hkv,
                          int Dh, int BS, int MB, int causal, int window,
                          int ring, int nsplit, float scale,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * DSTAGES * DK * Dh +
                      sizeof(long long) * DSTAGES * DK;
  static size_t granted[dyn_smem::MAX_DEVICES] = {};
  const auto kernel = paged_attention_decode_kernel<NC>;
  const cudaError_t err = dyn_smem::opt_in(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const int R = C * (H / Hkv);
  const dim3 grid(nsplit, Hkv * ((R + DR - 1) / DR), B);
  kernel<<<grid, DTHREADS, smem, stream>>>(
      (const float*)q, (const float*)kpool, (const float*)vpool,
      (const int32_t*)table, (const int32_t*)kv_len, (const int32_t*)q_off,
      (const int32_t*)newest, (float*)out, (float*)part, (int*)counters, C,
      H, Hkv, Dh, BS, MB, causal, window, ring, nsplit, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The tiled path (R = C * G > QT: prefill chunks).  A block owns TQ
// query rows of one (batch row, kv head); all G grouped heads of a row
// share each K/V tile.  Tiles of TK keys (any BS: a slot's block is
// looked up per slot) are staged with cp.async, double-buffered.  Thread
// (tr, tc) of 16 x 16 holds the scores of rows tr + 16 i and keys
// tc + 16 j (i, j < 4) in registers, from float4 shared-memory reads
// (8 loads per 64 FMAs; keys interleaved so that a quarter-warp's K rows
// fall on distinct banks), its rows' (m, l) softmax state, and the
// output of those rows at dims tc * 4 + 64 d (32 floats at Dh = 128).
// The weights go through shared memory transposed ([key][tr * 4 + i])
// so that P.V reads one float4 of weights and Dh / 64 float4s of V per
// key.  The walk covers only the slots that can hold a visible key:
// positions [qlo - window + 1, qhi] (clipped to [0, kv_len)) map to one
// arc of slots, modulo the ring's capacity on a ring; tiles the arc
// misses are skipped.  At Dh = 128 a block uses (64*132 + 2*64*132 +
// 2*64*128 + 64*68) * 4 = 184 KB of shared memory: one block per SM.
constexpr int TQ = 64;          // query rows per block
constexpr int TK = 64;          // keys per K/V tile
constexpr int TT = 256;         // threads

template <int DH, bool RING>
__global__ __launch_bounds__(TT, 1) void paged_attention_tiled_kernel(
    const float* __restrict__ q, const float* __restrict__ kpool,
    const float* __restrict__ vpool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ kv_len, const int32_t* __restrict__ q_off,
    const int32_t* __restrict__ newest_pos, float* __restrict__ out, int C,
    int H, int Hkv, int BS, int MB, int causal, int window, float scale) {
  constexpr int LDK = DH + 4, LDP = TQ + 4, ND = DH / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [TQ][LDK], pre-scaled
  float* Ks = Qs + TQ * LDK;           // [2][TK][LDK]
  float* Vs = Ks + 2 * TK * LDK;       // [2][TK][DH]
  float* Pt = Vs + 2 * TK * DH;        // [TK][LDP]: weights, transposed
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = H / Hkv, R = C * G;
  const int r0 = blockIdx.z * TQ, nr = min(TQ, R - r0);
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  for (int e = tid; e < TQ * DH / 4; e += TT) {
    const int r = e / (DH / 4), d = (e % (DH / 4)) * 4, row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nr) {
      const int c = row / G, h = kvh * G + row % G;
      v = *reinterpret_cast<const float4*>(
          q + (((size_t)b * C + c) * H + h) * DH + d);
      v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * LDK + d) = v;
  }

  const int len = kv_len[b], qoff = q_off[b];
  const int newest = RING ? newest_pos[b] : 0, cap = MB * BS;
  const int qlo = qoff + r0 / G, qhi = qoff + (r0 + nr - 1) / G;
  // the arc [alo, alo + an) of slots (mod cap) that can hold a visible key
  const int lo = window > 0 ? max(0, qlo - window + 1) : 0;
  int hi = causal ? min(len - 1, qhi) : len - 1;
  if (!RING) hi = min(hi, cap - 1);
  int alo = 0, an = hi - lo + 1;
  if (an >= cap) {
    an = cap;
  } else if (an > 0) {
    alo = RING ? lo % cap : lo;        // lo >= 0: floor modulo
  } else {
    an = 0;
  }
  const int ntiles = (cap + TK - 1) / TK;
  auto next_tile = [&](int t) {        // first tile >= t the arc touches
    for (; t < ntiles; ++t) {
      const int ts = t * TK, te = min(cap, ts + TK);
      if (max(ts, alo) < min(te, alo + an)) break;
      if (alo + an > cap && ts < alo + an - cap) break;   // wrapped part
    }
    return t;
  };
  auto load_kv = [&](int st, int t) {
    for (int e = tid; e < TK * (DH / 4); e += TT) {
      const int j = e / (DH / 4), d = (e % (DH / 4)) * 4, slot = t * TK + j;
      float* kd = Ks + (st * TK + j) * LDK + d;
      float* vd = Vs + (st * TK + j) * DH + d;
      if (slot < cap) {
        const size_t phys = (size_t)table[(size_t)b * MB + slot / BS];
        const size_t src = ((phys * BS + slot % BS) * Hkv + kvh) * DH + d;
        cp_async16(kd, kpool + src, 16);
        cp_async16(vd, vpool + src, 16);
      } else {                         // past the table: zeros, masked
        cp_async16(kd, kpool, 0);
        cp_async16(vd, vpool, 0);
      }
    }
  };

  float o[4][ND * 4], m_i[4], l_i[4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
    qpos[i] = qoff + (r0 + tr + 16 * i) / G;
#pragma unroll
    for (int e = 0; e < ND * 4; ++e) o[i][e] = 0.f;
  }

  int t = next_tile(0), st = 0;
  if (t < ntiles) load_kv(0, t);
  asm volatile("cp.async.commit_group;\n" ::);
  while (t < ntiles) {                 // block-uniform
    const int tn = next_tile(t + 1);
    if (tn < ntiles) load_kv(st ^ 1, tn);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();                   // Q, and tile t, in shared memory

    const float* K = Ks + st * TK * LDK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (tr + 16 * i) * LDK + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(K + (tc + 16 * j) * LDK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    int kpos[4];
    bool kok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int slot = t * TK + tc + 16 * j;
      kpos[j] = key_pos<RING>(slot, newest, cap);
      kok[j] = slot < cap && (!RING || kpos[j] >= 0) && kpos[j] < len;
    }
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool v = kok[j];
        if (causal) v = v && qpos[i] >= kpos[j];
        if (window > 0) v = v && qpos[i] - kpos[j] < window;
        valid[j] = v;
        if (v) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the 16 threads of row tr
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float a = expf(m_i[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_i[i] = l_i[i] * a + psum;
      m_i[i] = m_new;
#pragma unroll
      for (int e = 0; e < ND * 4; ++e) o[i][e] *= a;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tc + 16 * j) * LDP + tr * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();                   // weights in shared memory

    const float* V = Vs + st * TK * DH;
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + j * LDP + tr * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const float4 vv =
            *reinterpret_cast<const float4*>(V + j * DH + tc * 4 + 64 * dd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][dd * 4 + 0] += pr[i] * vv.x;
          o[i][dd * 4 + 1] += pr[i] * vv.y;
          o[i][dd * 4 + 2] += pr[i] * vv.z;
          o[i][dd * 4 + 3] += pr[i] * vv.w;
        }
      }
    }
    __syncthreads();                   // tile st and the weights consumed
    t = tn;
    st ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // a row that saw no key has l = 0 and o = 0: it writes zeros
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i, row = r0 + r;
    if (r >= nr) continue;
    const int c = row / G, h = kvh * G + row % G;
    float* dst = out + (((size_t)b * C + c) * H + h) * DH + tc * 4;
    const float l = fmaxf(l_i[i], 1e-20f);
#pragma unroll
    for (int dd = 0; dd < ND; ++dd)
      *reinterpret_cast<float4*>(dst + 64 * dd) =
          make_float4(o[i][dd * 4] / l, o[i][dd * 4 + 1] / l,
                      o[i][dd * 4 + 2] / l, o[i][dd * 4 + 3] / l);
  }
}

template <int DH, bool RING>
cudaError_t launch_tiled(const void* q, const void* kpool, const void* vpool,
                         const void* table, const void* kv_len,
                         const void* q_off, const void* newest, void* out,
                         int B, int C, int H, int Hkv, int BS, int MB,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) *
      ((size_t)TQ * (DH + 4) + 2 * TK * (DH + 4) + 2 * TK * DH +
       (size_t)TK * (TQ + 4));
  static size_t granted[dyn_smem::MAX_DEVICES] = {};
  const auto kernel = paged_attention_tiled_kernel<DH, RING>;
  const cudaError_t err = dyn_smem::opt_in(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const int R = C * (H / Hkv);
  const dim3 grid(B, Hkv, (R + TQ - 1) / TQ);
  kernel<<<grid, TT, smem, stream>>>(
      (const float*)q, (const float*)kpool, (const float*)vpool,
      (const int32_t*)table, (const int32_t*)kv_len, (const int32_t*)q_off,
      (const int32_t*)newest, (float*)out, C, H, Hkv, BS, MB, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// `part` and `counters` as paged_attention_decode_kernel's, needed on the
// decode walk when nsplit > 1; nsplit must cover decode_parts(MB*BS).
extern "C" int pa_paged_attention(const void* q, const void* kpool,
                                  const void* vpool, const void* table,
                                  const void* kv_len, const void* q_off,
                                  const void* newest, void* out, void* part,
                                  void* counters, int B, int C, int H,
                                  int Hkv, int Dh, int BS, int MB,
                                  int causal, int window, int ring,
                                  int nsplit, float scale, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  // the walks move Q, K/V and output rows with 16-byte accesses: rows of
  // Dh floats start 16-byte aligned in q, out and the pools
  if (Hkv <= 0 || H % Hkv != 0 || Dh <= 0 || BS <= 0 || MB <= 0 ||
      (ring && newest == nullptr) || Dh % 4 || BS % 4 ||
      (uintptr_t)kpool % 16 || (uintptr_t)vpool % 16 || (uintptr_t)q % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  // prefill chunks (more query rows than one decode tile) take the tiled
  // path at the head widths it is built for; other widths take the
  // decode walk, DR rows a block
  const int R = C * (H / Hkv);
  const cudaStream_t st = (cudaStream_t)stream;
  if (R > QT && (Dh == 64 || Dh == 128)) {
    const auto tiled = Dh == 64
        ? (ring ? launch_tiled<64, true> : launch_tiled<64, false>)
        : (ring ? launch_tiled<128, true> : launch_tiled<128, false>);
    return (int)tiled(q, kpool, vpool, table, kv_len, q_off, newest, out, B,
                      C, H, Hkv, BS, MB, causal, window, scale, st);
  }
  if (Dh > 256 || nsplit < decode_parts(MB * BS, ring) ||
      (nsplit > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto decode = Dh <= 32 ? launch_decode<1>
                      : Dh <= 64 ? launch_decode<2>
                      : Dh <= 128 ? launch_decode<4> : launch_decode<8>;
  return (int)decode(q, kpool, vpool, table, kv_len, q_off, newest, out,
                     part, counters, B, C, H, Hkv, Dh, BS, MB, causal,
                     window, ring, nsplit, scale, st);
}
