"""GQA attention block: QKV/O projections + RoPE around the attention
core, over a full sequence (``forward``) or the block-paged KV cache of
the serving engine (``paged_decode_step`` / ``prefill_chunk``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import ring_key_positions  # noqa: F401
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import common as C


def init(gen: torch.Generator, cfg, dtype=torch.float32, device=None) -> dict:
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "q": C.dense_init(gen, cfg.d_model, h * dh, bias=cfg.qkv_bias, **kw),
        "k": C.dense_init(gen, cfg.d_model, hkv * dh, bias=cfg.qkv_bias, **kw),
        "v": C.dense_init(gen, cfg.d_model, hkv * dh, bias=cfg.qkv_bias, **kw),
        "o": C.dense_init(gen, h * dh, cfg.d_model, **kw),
    }


def _qkv(params, cfg, x, positions, precision, impl, taps=None):
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = C.dense(x, params["q"], precision, impl, taps, "q").reshape(
        b, t, h, dh)
    k = C.dense(x, params["k"], precision, impl, taps, "k").reshape(
        b, t, hkv, dh)
    v = C.dense(x, params["v"], precision, impl, taps, "v").reshape(
        b, t, hkv, dh)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def forward(params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
            precision: str = "bf16", impl: str = "auto") -> torch.Tensor:
    b, t, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions, precision, impl)
    o = attn_mod.attention(q, k, v, causal=True, window=cfg.sliding_window,
                           q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    o = o.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return C.dense(o, params["o"], precision, impl)


# ---------------------------------------------------------------------------
# block-paged KV cache (serving engine; see repro_torch/serving/)
#
# The per-layer cache is a pool of fixed-size token blocks
# k/v: (num_blocks, block_size, Hkv, Dh).  A sequence owns a list of
# physical block ids; its (B, max_blocks) block table maps logical block
# index -> physical id.  Block 0 is a reserved scratch block: writes for
# padded/inactive rows are redirected there and never read back (every
# read is masked by the per-row kv_len).
#
# Sliding-window configs run the same pool as a RING: the logical block
# index (pos // bs) wraps modulo the table width, so a sequence only
# ever owns a window-sized block list and the trailing block is
# recycled to the front as the window advances.  Keys then sit out of
# positional order, so reads pass explicit per-slot positions
# (ring_key_positions) into the masks.


def init_paged_state(cfg, num_blocks: int, block_size: int,
                     dtype=torch.float32, device=None) -> dict:
    """Per-layer paged KV pool (the GQA mixer-state layout)."""
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gather_blocks(pool: torch.Tensor, block_table: torch.Tensor
                  ) -> torch.Tensor:
    """(num_blocks, bs, *rest) x (B, max_blocks) -> (B, max_blocks*bs,
    *rest) — a sequence's cached state, logically contiguous.  Slots past
    the owned blocks point at scratch block 0; callers mask by kv_len."""
    _nb, bs, *rest = pool.shape
    b, mb = block_table.shape
    return pool[block_table.long()].reshape(b, mb * bs, *rest)


def scatter_blocks(pool: torch.Tensor, block_table: torch.Tensor,
                   positions: torch.Tensor, values: torch.Tensor,
                   valid: torch.Tensor, *, ring: bool = False
                   ) -> torch.Tensor:
    """Write per-row token values into the paged pool, IN PLACE.

    positions (B, C) absolute token positions; values (B, C, *rest);
    valid (B, C) bool — invalid writes are redirected to scratch block 0
    (the JAX package's ``.at[].set`` returns a new pool; here the pool
    tensor itself is updated, and returned for symmetry).  ring=True
    wraps the logical block index modulo the table width (the
    sliding-window ring) instead of clipping it.
    """
    _nb, bs, *rest = pool.shape
    mb = block_table.shape[1]
    bidx = positions // bs
    bidx = torch.remainder(bidx, mb) if ring else bidx.clamp(0, mb - 1)
    phys = torch.gather(block_table.long(), 1, bidx.long())
    phys = torch.where(valid, phys, 0)
    offs = torch.where(valid, positions % bs, 0)
    pool[phys.reshape(-1), offs.reshape(-1)] = \
        values.reshape(-1, *rest).to(pool.dtype)
    return pool


def _paged_attend(cfg, q, cache, block_table, lengths, kv_len, newest,
                  ring, causal, impl):
    """GQA paged attention: the kernel walks the block table itself
    (``newest`` (B,), the highest position written, places the ring's
    slots)."""
    return kops.paged_attention(
        q.float().contiguous(), cache["k"], cache["v"], block_table,
        kv_len=kv_len, q_offset=lengths, causal=causal,
        window=cfg.sliding_window, ring=ring,
        newest=newest.to(torch.int32).contiguous() if ring else None,
        impl=impl).to(q.dtype)


def paged_decode_step(params, cfg, x: torch.Tensor, cache,
                      block_table: torch.Tensor, lengths: torch.Tensor, *,
                      precision: str = "bf16",
                      active: torch.Tensor | None = None,
                      ring: bool = False, impl: str = "auto",
                      taps: list | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode against the paged pool with PER-ROW lengths.

    x (B, 1, d); block_table (B, max_blocks) int32; lengths (B,) int32
    current per-sequence cache fill; active (B,) bool masks padded batch
    slots; ring=True treats the table as a sliding-window ring.  The
    pools in ``cache`` are updated in place.  ``taps`` as in
    ``prefill_chunk``.
    """
    b = x.shape[0]
    positions = lengths[:, None].long()                          # (B, 1)
    q, k, v = _qkv(params, cfg, x, positions, precision, impl, taps)
    valid = (torch.ones((b, 1), dtype=torch.bool, device=x.device)
             if active is None else active[:, None])
    scatter_blocks(cache["k"], block_table, positions, k, valid, ring=ring)
    scatter_blocks(cache["v"], block_table, positions, v, valid, ring=ring)
    o = _paged_attend(cfg, q, cache, block_table, lengths, lengths + 1,
                      lengths, ring, causal=False, impl=impl)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return C.dense(o, params["o"], precision, impl, taps, "o"), cache


def prefill_chunk(params, cfg, x: torch.Tensor, cache,
                  block_table: torch.Tensor, lengths: torch.Tensor,
                  n_valid: torch.Tensor, *, precision: str = "bf16",
                  ring: bool = False, impl: str = "auto",
                  taps: list | None = None) -> tuple[torch.Tensor, dict]:
    """Chunked prefill: C tokens per row appended at per-row offsets.

    x (B, C, d); lengths (B,) tokens already cached; n_valid (B,) how
    many of the C chunk positions are real (the rest are padding).
    Causal within the chunk, full (or window-masked) attention to the
    cached prefix; ring=True as in ``paged_decode_step``.  The pools in
    ``cache`` are updated in place.  ``taps``, when a list, receives
    ``(name, input)`` of each projection (q, k, v, o).
    """
    b, ch, _ = x.shape
    ar = torch.arange(ch, device=x.device)
    positions = lengths[:, None].long() + ar[None, :]
    q, k, v = _qkv(params, cfg, x, positions, precision, impl, taps)
    valid = ar[None, :] < n_valid[:, None]
    scatter_blocks(cache["k"], block_table, positions, k, valid, ring=ring)
    scatter_blocks(cache["v"], block_table, positions, v, valid, ring=ring)
    o = _paged_attend(cfg, q, cache, block_table, lengths,
                      lengths + n_valid, lengths + n_valid - 1, ring,
                      causal=True, impl=impl)
    o = o.reshape(b, ch, cfg.n_heads * cfg.head_dim)
    return C.dense(o, params["o"], precision, impl, taps, "o"), cache
