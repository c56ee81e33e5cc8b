"""Paged GQA attention: walk each row's block table over the K/V pools.

q (B, C, H, Dh); k/v pools (NB, BS, Hkv, Dh); block_table (B, MB) int32
physical block ids; kv_len/q_offset (B,) int32 per-row valid length and
absolute position of q[:, 0].  Semantics are the Pallas kernel's
(src/repro/kernels/paged_attention.py, layout="gqa", ring=False): q is
scaled by Dh^-0.5, keys at logical position >= kv_len are masked, as
are (causal) keys after the query and (window) keys a window or more
behind it; a fully-masked query row returns exact zeros.

``paged_attention`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel (csrc/paged_attention.cu) or raises; on a CPU
tensor it computes ``paged_attention_torch``, the plain version.  The
ring and MLA variants are not ported yet (ROADMAP.md queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

KERNEL = _lib.KernelInfo(
    "paged_attention", "src/repro_torch/csrc/paged_attention.cu",
    "src/repro/kernels/paged_attention.py:169")

NEG_INF = -1e30


def _refuse_variants(layout: str, ring: bool):
    if layout != "gqa":
        raise NotImplementedError(
            f"paged attention layout={layout!r} is not ported "
            "(ROADMAP.md queue 2, item 5)")
    if ring:
        raise NotImplementedError(
            "paged attention ring=True is not ported (ROADMAP.md queue 2, "
            "item 4)")


def paged_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor, *,
                          kv_len: torch.Tensor, q_offset: torch.Tensor,
                          causal: bool = False, window: int | None = None,
                          layout: str = "gqa", ring: bool = False
                          ) -> torch.Tensor:
    """Plain version: gather the row's blocks, one masked softmax."""
    _refuse_variants(layout, ring)
    b, c, h, dh = q.shape
    _nb, bs, hkv, dv = v_pool.shape
    mb = block_table.shape[1]
    g = h // hkv
    keys = k_pool[block_table].reshape(b, mb * bs, hkv, dh).float()
    vals = v_pool[block_table].reshape(b, mb * bs, hkv, dv).float()
    qf = q.float() * (dh ** -0.5)
    scores = torch.einsum("bckgd,bskd->bkgcs", qf.reshape(b, c, hkv, g, dh),
                          keys)
    kpos = torch.arange(mb * bs, device=q.device)
    qpos = q_offset.long()[:, None] + torch.arange(c, device=q.device)
    mask = (kpos[None, None, :] < kv_len.long()[:, None, None]).expand(
        b, c, mb * bs)
    if causal:
        mask = mask & (qpos[:, :, None] >= kpos)
    if window is not None and window > 0:
        mask = mask & (qpos[:, :, None] - kpos < window)
    mask = mask[:, None, None]                         # (B, 1, 1, C, S)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1)                                  # (B, Hkv, G, C)
    o = torch.einsum("bkgcs,bskd->bckgd", p, vals)
    o = o / l.clamp_min(1e-20).permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, c, h, dv).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor, *,
                    kv_len: torch.Tensor, q_offset: torch.Tensor,
                    causal: bool = False, window: int | None = None,
                    layout: str = "gqa", ring: bool = False) -> torch.Tensor:
    """Fused block-table walk + online-softmax attention; returns
    (B, C, H, Dh) float32."""
    if q.device.type == "cpu":
        return paged_attention_torch(
            q, k_pool, v_pool, block_table, kv_len=kv_len, q_offset=q_offset,
            causal=causal, window=window, layout=layout, ring=ring)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    _refuse_variants(layout, ring)
    b, c, h, dh = q.shape
    nb, bs, hkv, _ = k_pool.shape
    mb = block_table.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(f"paged_attention: {h} heads over {hkv} kv heads")
    dev = q.device
    _lib.check(q, "q", torch.float32, (b, c, h, dh), dev)
    _lib.check(k_pool, "k_pool", torch.float32, (nb, bs, hkv, dh), dev)
    _lib.check(v_pool, "v_pool", torch.float32, (nb, bs, hkv, dh), dev)
    _lib.check(block_table, "block_table", torch.int32, (b, mb), dev)
    _lib.check(kv_len, "kv_len", torch.int32, (b,), dev)
    _lib.check(q_offset, "q_offset", torch.int32, (b,), dev)
    out = torch.empty_like(q)
    _lib.launch("pa_paged_attention", _lib.ptr(q), _lib.ptr(k_pool),
                _lib.ptr(v_pool), _lib.ptr(block_table), _lib.ptr(kv_len),
                _lib.ptr(q_offset), _lib.ptr(out), b, c, h, hkv, dh, bs, mb,
                int(causal), int(window or 0), float(dh ** -0.5))
    KERNEL.launches += 1
    return out
