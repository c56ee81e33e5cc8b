"""Paged attention: walk each row's block table over the KV pools.

Three variants of the Pallas kernel's template
(src/repro/kernels/paged_attention.py), one KernelInfo each:

* GQA (``paged_attention``): q (B, C, H, Dh); k/v pools
  (NB, BS, Hkv, Dh); grouped heads.  csrc/paged_attention.cu: a split
  decode walk (``decode_parts`` parts of DECODE_PART_KEYS positions a
  row, merged in the launch) for C·G <= 16 query rows per (batch row,
  kv head), a tiled prefill path (``gqa_tiled``) for more.
* GQA over a sliding-window ring (``paged_attention(..., ring=True)``):
  the same pools, but slot s of the (MB * BS)-slot table holds position
  ``newest - ((newest - s) mod (MB * BS))`` (floor modulo), where
  ``newest`` (B,) is the highest position written; a negative position
  was never written and is masked.  csrc/paged_attention.cu.
* MLA latents (``paged_attention_mla``): pools c_kv (NB, BS, R) and
  k_rope (NB, BS, Dr); per-head K_nope = c_kv · k_up and V = c_kv · v_up
  with k_up (R, H * nope) and v_up (R, H * Dv); q packs [nope ++ rope]
  on its last axis.  ``ring`` composes here too.
  csrc/paged_attention_mla.cu: for C·H <= 16 query rows per batch row
  a decode route (two small-M GEMMs and a split walk over
  ``mla_decode_parts`` parts of MLA_PART_KEYS positions a row, merged
  in the launch), a tiled prefill route (``mla_tiled``) for more.

block_table (B, MB) int32 physical block ids; kv_len/q_offset (B,)
int32 per-row valid length and absolute position of q[:, 0].  q is
scaled by Dq^-0.5 (Dq = q.shape[-1]); keys at position >= kv_len or < 0
are masked, as are (causal) keys after the query and (window) keys a
window or more behind it; a fully-masked query row returns exact zeros.

Each wrapper launches its hand-written kernel on a CUDA tensor or
raises; on a CPU tensor it computes the ``*_torch`` plain version.  The
plain MLA version decompresses K and V first, as the Pallas body does;
the kernel absorbs k_up into the query instead (same function, another
summation order).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

_REPLACES = "src/repro/kernels/paged_attention.py:169"
KERNEL = _lib.KernelInfo(
    "paged_attention", "src/repro_torch/csrc/paged_attention.cu", _REPLACES)
KERNEL_RING = _lib.KernelInfo(
    "paged_attention_ring", "src/repro_torch/csrc/paged_attention.cu",
    _REPLACES)
KERNEL_MLA = _lib.KernelInfo(
    "paged_attention_mla", "src/repro_torch/csrc/paged_attention_mla.cu",
    _REPLACES)

NEG_INF = -1e30
MLA_ROWS = 16          # most query rows (c, h) of a batch row at decode
MLA_TILE_ROWS = 8      # query rows a block of the MLA decode walk owns
MLA_PART_KEYS = 128    # positions per part of the MLA decode walk
MLA_DECODE_MAX_R = 512     # latent width the MLA decode walk holds
MLA_TILED_WIDTHS = (512, 64)   # (R, Dr) the MLA tiled prefill path takes
DECODE_ROWS = 4        # query rows per block of the GQA decode walk
DECODE_PART_KEYS = 256     # positions per part of the GQA decode walk
GQA_TILED_ROWS = 16    # more query rows than this per (batch row, kv
GQA_TILED_WIDTHS = (64, 128)   # head), at these Dh, take the tiled path


def ring_key_positions(newest: torch.Tensor, mb: int, bs: int
                       ) -> torch.Tensor:
    """(B, mb*bs) absolute position of every ring slot: slot s holds the
    most recent position congruent to s modulo the ring capacity,
    ``newest - ((newest - s) mod R)``; never-written slots come out
    negative.  ``torch.remainder`` is the floor modulo the formula needs
    (``newest - s`` is negative for slots not reached yet)."""
    r = mb * bs
    s = torch.arange(r, device=newest.device)
    nw = newest.long()[:, None]
    return nw - torch.remainder(nw - s[None, :], r)


def _key_positions(b, mb, bs, ring, newest, device) -> torch.Tensor:
    if ring:
        if newest is None:
            raise ValueError("ring=True needs the per-row `newest` positions")
        return ring_key_positions(newest, mb, bs)
    return torch.arange(mb * bs, device=device)[None].expand(b, mb * bs)


def _mask(kpos, kv_len, q_offset, c, causal, window) -> torch.Tensor:
    """(B, C, S) visibility of every key slot to every chunk query."""
    qpos = q_offset.long()[:, None] + torch.arange(c, device=kpos.device)
    mask = ((kpos >= 0) & (kpos < kv_len.long()[:, None]))[:, None, :]
    mask = mask.expand(kpos.shape[0], c, kpos.shape[1])
    if causal:
        mask = mask & (qpos[:, :, None] >= kpos[:, None, :])
    if window is not None and window > 0:
        mask = mask & (qpos[:, :, None] - kpos[:, None, :] < window)
    return mask


def _softmax_rows(scores, mask):
    """Masked softmax over the last axis; fully-masked rows give 0."""
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)


def paged_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor, *,
                          kv_len: torch.Tensor, q_offset: torch.Tensor,
                          causal: bool = False, window: int | None = None,
                          ring: bool = False,
                          newest: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Plain version (GQA, ring or not): gather the row's blocks, one
    masked softmax."""
    b, c, h, dh = q.shape
    _nb, bs, hkv, dv = v_pool.shape
    mb = block_table.shape[1]
    g = h // hkv
    tab = block_table.long()
    keys = k_pool[tab].reshape(b, mb * bs, hkv, dh).float()
    vals = v_pool[tab].reshape(b, mb * bs, hkv, dv).float()
    qf = q.float() * (dh ** -0.5)
    scores = torch.einsum("bckgd,bskd->bkgcs", qf.reshape(b, c, hkv, g, dh),
                          keys)
    kpos = _key_positions(b, mb, bs, ring, newest, q.device)
    mask = _mask(kpos, kv_len, q_offset, c, causal, window)[:, None, None]
    p = _softmax_rows(scores, mask)                    # (B, Hkv, G, C, S)
    o = torch.einsum("bkgcs,bskd->bckgd", p, vals)
    return o.reshape(b, c, h, dv).to(q.dtype)


def paged_attention_mla_torch(q: torch.Tensor, c_kv_pool: torch.Tensor,
                              k_rope_pool: torch.Tensor,
                              block_table: torch.Tensor, *,
                              k_up: torch.Tensor, v_up: torch.Tensor,
                              nope_dim: int, kv_len: torch.Tensor,
                              q_offset: torch.Tensor, causal: bool = False,
                              window: int | None = None, ring: bool = False,
                              newest: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain version (MLA latents, ring or not): gather the latents,
    decompress per-head K_nope and V, one masked softmax."""
    b, c, h, dq = q.shape
    _nb, bs, r = c_kv_pool.shape
    dr = k_rope_pool.shape[2]
    mb = block_table.shape[1]
    dv = v_up.shape[1] // h
    tab = block_table.long()
    lat = c_kv_pool[tab].reshape(b, mb * bs, r).float()
    rope = k_rope_pool[tab].reshape(b, mb * bs, dr).float()
    k_nope = torch.matmul(lat, k_up.float()).reshape(b, mb * bs, h, nope_dim)
    vals = torch.matmul(lat, v_up.float()).reshape(b, mb * bs, h, dv)
    qf = q.float() * (dq ** -0.5)
    scores = (torch.einsum("bchd,bshd->bhcs", qf[..., :nope_dim], k_nope)
              + torch.einsum("bchd,bsd->bhcs", qf[..., nope_dim:], rope))
    kpos = _key_positions(b, mb, bs, ring, newest, q.device)
    mask = _mask(kpos, kv_len, q_offset, c, causal, window)[:, None]
    p = _softmax_rows(scores, mask)                    # (B, H, C, S)
    o = torch.einsum("bhcs,bshd->bchd", p, vals)
    return o.to(q.dtype)


def _check_rows(q, block_table, kv_len, q_offset, ring, newest):
    b, _c = q.shape[:2]
    mb = block_table.shape[1]
    dev = q.device
    _lib.check(block_table, "block_table", torch.int32, (b, mb), dev)
    _lib.check(kv_len, "kv_len", torch.int32, (b,), dev)
    _lib.check(q_offset, "q_offset", torch.int32, (b,), dev)
    if ring:
        if newest is None:
            raise ValueError("ring=True needs the per-row `newest` positions")
        _lib.check(newest, "newest", torch.int32, (b,), dev)
        return _lib.ptr(newest)
    return None


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor, *,
                    kv_len: torch.Tensor, q_offset: torch.Tensor,
                    causal: bool = False, window: int | None = None,
                    ring: bool = False,
                    newest: torch.Tensor | None = None) -> torch.Tensor:
    """Fused block-table walk + online-softmax GQA attention, over a
    paged table or (``ring``) a sliding-window ring; returns
    (B, C, H, Dh) float32."""
    if q.device.type == "cpu":
        return paged_attention_torch(
            q, k_pool, v_pool, block_table, kv_len=kv_len, q_offset=q_offset,
            causal=causal, window=window, ring=ring, newest=newest)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    b, c, h, dh = q.shape
    nb, bs, hkv, _ = k_pool.shape
    mb = block_table.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(f"paged_attention: {h} heads over {hkv} kv heads")
    if dh % 4 or bs % 4 or any(t.data_ptr() % 16
                               for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention: the kernel moves Q and K/V rows "
                         "16 bytes at a time; Dh and the block size must be "
                         "multiples of 4 and q and the pools 16-byte aligned")
    dev = q.device
    _lib.check(q, "q", torch.float32, (b, c, h, dh), dev)
    _lib.check(k_pool, "k_pool", torch.float32, (nb, bs, hkv, dh), dev)
    _lib.check(v_pool, "v_pool", torch.float32, (nb, bs, hkv, dh), dev)
    newest_p = _check_rows(q, block_table, kv_len, q_offset, ring, newest)
    out = torch.empty_like(q)
    g = h // hkv
    ns = 1 if gqa_tiled(c, g, dh) else decode_parts(mb, bs, ring)
    part = counters = None
    if ns > 1:          # each part's (acc, m, l) per query row, merged by
        tiles = -(-(c * g) // DECODE_ROWS)      # the last part to arrive
        part = torch.empty((b, hkv, tiles * DECODE_ROWS, ns, dh + 2),
                           dtype=torch.float32, device=dev)
        counters = _decode_counters(dev, b * hkv * tiles)
    _lib.launch("pa_paged_attention", dev, _lib.ptr(q), _lib.ptr(k_pool),
                _lib.ptr(v_pool), _lib.ptr(block_table), _lib.ptr(kv_len),
                _lib.ptr(q_offset), newest_p, _lib.ptr(out),
                None if part is None else _lib.ptr(part),
                None if counters is None else _lib.ptr(counters),
                b, c, h, hkv, dh, bs, mb, int(causal), int(window or 0),
                int(ring), ns, float(dh ** -0.5))
    (KERNEL_RING if ring else KERNEL).launches += 1
    return out


def gqa_tiled(c: int, g: int, dh: int) -> bool:
    """Whether the GQA kernel takes its tiled prefill path: more query
    rows per (batch row, kv head) than a decode tile, at the head widths
    the path is built for; every other call takes the decode walk."""
    return c * g > GQA_TILED_ROWS and dh in GQA_TILED_WIDTHS


def decode_parts(mb: int, bs: int, ring: bool) -> int:
    """Blocks the GQA decode walk's grid gives each (batch row, kv head,
    row tile): one per part of DECODE_PART_KEYS consecutive positions
    that the row's visible keys can touch, from the table width alone
    (no batch size, no device read).  A paged row sees positions inside
    [0, mb * bs); a ring row at most mb * bs consecutive positions,
    which may start mid-part.  A block whose part lies past its row's
    visible keys exits at once."""
    cap = mb * bs
    if ring:
        return -(-(cap - 1) // DECODE_PART_KEYS) + 1
    return -(-cap // DECODE_PART_KEYS)


_counters: dict[torch.device, torch.Tensor] = {}
_retired: list[torch.Tensor] = []


def _decode_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` per-row-tile counters of the decode walk's merge on
    ``device``: zeroed once and left at zero by every launch (the last
    part of a row tile resets its counter).  Launches that share them run
    in order on one stream.  A buffer that is outgrown stays allocated:
    a captured CUDA graph may still point at it."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        size = max(n, 4096, 2 * (0 if buf is None else buf.numel()))
        buf = _counters[device] = torch.zeros(size, dtype=torch.int32,
                                              device=device)
    return buf


def mla_decode_parts(mb: int, bs: int, ring: bool) -> int:
    """Blocks the MLA decode walk's grid gives each (batch row, tile of
    MLA_TILE_ROWS query rows): one per part of MLA_PART_KEYS consecutive
    positions that the row's visible keys can touch, from the table
    width alone, as ``decode_parts`` for the GQA walk."""
    cap = mb * bs
    if ring:
        return -(-(cap - 1) // MLA_PART_KEYS) + 1
    return -(-cap // MLA_PART_KEYS)


def mla_tiled(c: int, h: int, r: int, dr: int) -> bool:
    """Whether the MLA kernel takes its tiled prefill path (64 query rows
    a block, tensor cores): more query rows per batch row than one
    decode block holds, at the latent widths the path is built for."""
    return c * h > MLA_ROWS and (r, dr) == MLA_TILED_WIDTHS


def paged_attention_mla(q: torch.Tensor, c_kv_pool: torch.Tensor,
                        k_rope_pool: torch.Tensor, block_table: torch.Tensor,
                        *, k_up: torch.Tensor, v_up: torch.Tensor,
                        nope_dim: int, kv_len: torch.Tensor,
                        q_offset: torch.Tensor, causal: bool = False,
                        window: int | None = None, ring: bool = False,
                        newest: torch.Tensor | None = None,
                        route_heads: int | None = None) -> torch.Tensor:
    """Fused latent walk + online-softmax MLA attention with in-kernel
    K/V decompression; returns (B, C, H, Dv) float32.  ``route_heads``
    (default H) is the head count whose C·H query rows choose the route
    (``mla_tiled``): over a mesh the layer's, so a rank's heads take
    the route one rank takes."""
    if q.device.type == "cpu":
        return paged_attention_mla_torch(
            q, c_kv_pool, k_rope_pool, block_table, k_up=k_up, v_up=v_up,
            nope_dim=nope_dim, kv_len=kv_len, q_offset=q_offset,
            causal=causal, window=window, ring=ring, newest=newest)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_mla: no kernel for device "
                         f"{q.device}")
    b, c, h, dq = q.shape
    nb, bs, r = c_kv_pool.shape
    dr = k_rope_pool.shape[2]
    mb = block_table.shape[1]
    if dq != nope_dim + dr or v_up.shape[1] % h:
        raise ValueError(f"paged_attention_mla: q width {dq} is not "
                         f"nope {nope_dim} + rope {dr}, or v_up "
                         f"{tuple(v_up.shape)} does not split over {h} heads")
    dv = v_up.shape[1] // h
    if any(x % 4 for x in (r, dr, nope_dim, dv)) or any(
            t.data_ptr() % 16 for t in (q, c_kv_pool, k_rope_pool, k_up,
                                        v_up)):
        raise ValueError("paged_attention_mla: the kernels move rows 16 "
                         "bytes at a time; R, Dr, nope and Dv must be "
                         "multiples of 4 and q, the pools, k_up and v_up "
                         "16-byte aligned")
    dev = q.device
    _lib.check(q, "q", torch.float32, (b, c, h, dq), dev)
    _lib.check(c_kv_pool, "c_kv_pool", torch.float32, (nb, bs, r), dev)
    _lib.check(k_rope_pool, "k_rope_pool", torch.float32, (nb, bs, dr), dev)
    _lib.check(k_up, "k_up", torch.float32, (r, h * nope_dim), dev)
    _lib.check(v_up, "v_up", torch.float32, (r, h * dv), dev)
    newest_p = _check_rows(q, block_table, kv_len, q_offset, ring, newest)
    tiled = mla_tiled(c, max(h, route_heads or h), r, dr)
    if not tiled and r > MLA_DECODE_MAX_R:
        raise ValueError(f"paged_attention_mla: the decode walk holds a "
                         f"latent of at most {MLA_DECODE_MAX_R}, not {r}")
    ns = 1 if tiled else mla_decode_parts(mb, bs, ring)
    rows = b * c * h
    q_lat = torch.empty((rows, r), dtype=torch.float32, device=dev)
    merged = torch.empty((rows, r), dtype=torch.float32, device=dev)
    out = torch.empty((b, c, h, dv), dtype=torch.float32, device=dev)
    part = counters = None
    if ns > 1:          # each part's (acc, m, l) per query row, merged by
        tiles = -(-(c * h) // MLA_TILE_ROWS)    # the last part to arrive
        part = torch.empty((b, tiles * MLA_TILE_ROWS, ns, r + 4),
                           dtype=torch.float32, device=dev)
        counters = _decode_counters(dev, b * tiles)
    _lib.launch("pm_paged_attention_mla", dev, _lib.ptr(q),
                _lib.ptr(c_kv_pool), _lib.ptr(k_rope_pool),
                _lib.ptr(block_table),
                _lib.ptr(kv_len), _lib.ptr(q_offset), newest_p,
                _lib.ptr(k_up), _lib.ptr(v_up), _lib.ptr(q_lat),
                None if part is None else _lib.ptr(part),
                None if counters is None else _lib.ptr(counters),
                _lib.ptr(merged), _lib.ptr(out), b, c, h, r, dr, nope_dim,
                dv, bs, mb, int(causal), int(window or 0), int(ring), ns,
                int(tiled), float(dq ** -0.5))
    KERNEL_MLA.launches += 1
    return out
