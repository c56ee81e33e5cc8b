"""Grouped-query attention with chunked online-softmax (flash-style).

Never materializes the full (T, S) score matrix: queries are processed
in chunks of ``q_chunk`` and, for each, KV is walked in chunks of
``kv_chunk`` with a running (max, sum, acc) online softmax, merged in
the same order as the JAX package (so the float results agree to
rounding).  Supports causal masking, sliding windows, GQA/MQA head
grouping, per-row ``q_offset``/``kv_len``, and zeros for fully-masked
rows, and explicit per-slot key positions (``k_positions``) for the
ring-buffer caches of sliding-window models.

Shapes: q (B, T, H, Dh), k/v (B, S, Hkv, Dh); H = G * Hkv.

On ``meta`` tensors (the dry-run: shapes, no values) the chunk loops
give way to one tile: ``_OneTile`` runs the first (q chunk, kv chunk)
pair for what it allocates and returns the output's shape, as a kernel
that holds one tile at a time would; a step's meta run then walks a
32k-token attention in one tile's ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _per_row(v, b: int, device) -> torch.Tensor:
    """Scalar or (B,) -> (B,) int64."""
    return torch.as_tensor(v, device=device).long().expand(b)


def _chunk_attend(q, k, v, q_pos, k_pos, causal, window, kv_len):
    """Scores + online-softmax terms for one (q_chunk, kv_chunk) tile.

    q: (B, Tq, H, Dh); k, v: (B, Sk, Hkv, Dh); q_pos (B, Tq); k_pos
    (B, Sk) per-row key positions (negative = padding, masked); kv_len
    (B,).  Returns (m, l, o) partials: m (B, Hkv, G, Tq), l likewise,
    o (B, Tq, H, Dv).
    """
    b, tq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.float() * (dh ** -0.5)
    scores = torch.einsum("btkgd,bskd->bkgts", qf.reshape(b, tq, hkv, g, dh),
                          k.float())
    mask = k_pos[:, None, :] >= 0
    if causal:
        mask = mask & (q_pos[:, :, None] >= k_pos[:, None, :])
    if window is not None and window > 0:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    if kv_len is not None:
        mask = mask & (k_pos[:, None, :] < kv_len[:, None, None])
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    m = scores.amax(dim=-1)                             # (B,Hkv,G,Tq)
    p = torch.exp(scores - m[..., None])
    valid = m > NEG_INF / 2                             # fully-masked rows
    p = torch.where(valid[..., None], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return m, l, o.reshape(b, tq, h, v.shape[-1])


def _merge(m1, l1, o1, m2, l2, o2):
    """Merge two online-softmax partials."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    b, hkv, g, tq = m.shape
    sh = (b, tq, hkv * g, 1)
    o = o1 * a1.permute(0, 3, 1, 2).reshape(sh) + \
        o2 * a2.permute(0, 3, 1, 2).reshape(sh)
    return m, l, o


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: int | None = None,
              q_offset=0,
              kv_len=None,
              k_positions: torch.Tensor | None = None,
              q_chunk: int = 512,
              kv_chunk: int = 1024) -> torch.Tensor:
    """Chunked flash-style attention.

    q_offset: absolute position of q[:, 0]; scalar or (B,) per row
      (continuous-batching decode / chunked prefill).
    kv_len: optional valid length of k/v; scalar or (B,) per row.
    k_positions: optional (B, S) absolute position of every key slot,
      replacing the default arange — a ring-buffer cache stores keys out
      of positional order.  The causal, window and kv_len masks use
      these positions; a negative entry marks a never-written slot and
      is always masked.
    """
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len, k_positions=k_positions, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    if q.device.type == "meta":
        return _OneTile.apply(q, k, v, kw)
    return _chunked(q, k, v, **kw)


def _chunked(q, k, v, *, causal, window, q_offset, kv_len, k_positions,
             q_chunk, kv_chunk) -> torch.Tensor:
    """``attention``'s chunk loops."""
    b, t, h, dh = q.shape
    s = k.shape[1]
    hkv = k.shape[2]
    dv = v.shape[3]
    g = h // hkv
    dev = q.device
    q_chunk = min(q_chunk, t)
    kv_chunk = min(kv_chunk, s)
    tp = -(-t // q_chunk) * q_chunk
    sp = -(-s // kv_chunk) * kv_chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, tp - t))
    kp = F.pad(k, (0, 0, 0, 0, 0, sp - s))
    vp = F.pad(v, (0, 0, 0, 0, 0, sp - s))
    eff_len = _per_row(kv_len if kv_len is not None else s, b, dev)
    q_off = _per_row(q_offset, b, dev)
    if k_positions is None:
        # padded slots (>= s) get position -1: a zero-K pad slot never
        # passes the masks, even when kv_len overshoots the real S
        ar = torch.arange(sp, device=dev)
        kpos_full = torch.where(ar < s, ar, -1)[None].expand(b, sp)
    else:
        kpos_full = F.pad(k_positions.long(), (0, sp - s), value=-1)

    outs = []
    for qi in range(tp // q_chunk):
        qc = qp[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = torch.arange(q_chunk, device=dev)[None, :] \
            + qi * q_chunk + q_off[:, None]
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), device=dev)
        o = torch.zeros((b, q_chunk, h, dv), device=dev)
        for ki in range(sp // kv_chunk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            m2, l2, o2 = _chunk_attend(qc, kp[:, sl], vp[:, sl], q_pos,
                                       kpos_full[:, sl], causal, window,
                                       eff_len)
            m, l, o = _merge(m, l, o, m2, l2, o2)
        l = l.clamp_min(1e-20)
        outs.append(o / l.permute(0, 3, 1, 2).reshape(b, q_chunk, h, 1))
    return torch.cat(outs, dim=1)[:, :t].to(q.dtype)


def _one_tile(q, k, v, kw) -> torch.Tensor:
    """``attention`` over the first q chunk against the first kv chunk;
    the whole output's shape (``empty``) where that is not all of it."""
    b, t, h, _ = q.shape
    s = k.shape[1]
    tq, sk = min(kw["q_chunk"], t), min(kw["kv_chunk"], s)
    kp = kw["k_positions"]
    o = _chunked(q[:, :tq], k[:, :sk], v[:, :sk],
                 **{**kw, "k_positions": None if kp is None else kp[:, :sk]})
    if (tq, sk) == (t, s):
        return o
    del o
    return torch.empty((b, t, h, v.shape[3]), dtype=q.dtype, device=q.device)


class _OneTile(torch.autograd.Function):
    """``attention`` on ``meta`` (module docstring): forward one tile and
    the output's shape; backward one tile again, as a flash backward
    recomputes its tiles, and the gradients' shapes."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.kw = kw
        ctx.save_for_backward(q, k, v)
        return _one_tile(q, k, v, kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        del g
        _one_tile(q, k, v, ctx.kw)
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None)


def attention_reference(q, k, v, *, causal=True, window=None, q_offset=0,
                        kv_len=None, k_positions=None):
    """O(T*S) reference for tests."""
    b, t, h, dh = q.shape
    s = k.shape[1]
    g = h // k.shape[2]
    dev = q.device
    kf = k.repeat_interleave(g, dim=2).float()
    vf = v.repeat_interleave(g, dim=2).float()
    scores = torch.einsum("bthd,bshd->bhts", q.float() * dh ** -0.5, kf)
    q_pos = torch.arange(t, device=dev)[None] + _per_row(q_offset, b, dev)[:, None]
    k_pos = (torch.arange(s, device=dev)[None].expand(b, s)
             if k_positions is None else k_positions.long())
    mask = k_pos[:, None, :] >= 0
    if causal:
        mask = mask & (q_pos[:, :, None] >= k_pos[:, None, :])
    if window is not None and window > 0:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    if kv_len is not None:
        mask = mask & (k_pos[:, None, :] < _per_row(kv_len, b, dev)[:, None, None])
    scores = torch.where(mask[:, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    # fully-masked rows: softmax of all-NEG_INF is uniform — zero it to
    # match the flash path (which emits 0 when nothing is attendable)
    p = torch.where(mask.any(dim=-1)[:, None, :, None], p, 0.0)
    out = torch.einsum("bhts,bshd->bthd", p, vf)
    return out.to(q.dtype)
