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
// chunks, Dh = 64 or 128) the tiled path further down.
//
// Decode design: the TPU walked the table as a sequential grid axis with the
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

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
  static bool opted_in = false;
  const auto kernel = paged_attention_tiled_kernel<DH, RING>;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
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

extern "C" int pa_paged_attention(const void* q, const void* kpool,
                                  const void* vpool, const void* table,
                                  const void* kv_len, const void* q_off,
                                  const void* newest, void* out, int B,
                                  int C, int H, int Hkv, int Dh, int BS,
                                  int MB, int causal, int window, int ring,
                                  float scale, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  // the walks move Q, K/V and output rows with 16-byte accesses: rows of
  // Dh floats start 16-byte aligned in q, out and the pools and, with
  // BS % 4 == 0, in every warp's shared-memory slice
  if (Hkv <= 0 || H % Hkv != 0 || Dh <= 0 || BS <= 0 || MB <= 0 ||
      (ring && newest == nullptr) || Dh % 4 || BS % 4 ||
      (uintptr_t)kpool % 16 || (uintptr_t)vpool % 16 || (uintptr_t)q % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  // prefill chunks (more query rows than one decode tile) take the tiled
  // path at the head widths it is built for; other widths take the
  // decode walk, 16 rows a block
  const int R = C * (H / Hkv);
  const cudaStream_t st = (cudaStream_t)stream;
  if (R > QT && (Dh == 64 || Dh == 128)) {
    const auto tiled = Dh == 64
        ? (ring ? launch_tiled<64, true> : launch_tiled<64, false>)
        : (ring ? launch_tiled<128, true> : launch_tiled<128, false>);
    return (int)tiled(q, kpool, vpool, table, kv_len, q_off, newest, out, B,
                      C, H, Hkv, BS, MB, causal, window, scale, st);
  }
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
  const dim3 grid(B, Hkv, (R + QT - 1) / QT);
  kernel<<<grid, NW * 32, smem, st>>>(
      (const float*)q, (const float*)kpool, (const float*)vpool,
      (const int32_t*)table, (const int32_t*)kv_len, (const int32_t*)q_off,
      (const int32_t*)newest, (float*)out, C, H, Hkv, Dh, BS, MB, causal,
      window, scale);
  return (int)cudaGetLastError();
}
