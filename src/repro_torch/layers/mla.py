"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

KV are compressed to a low-rank latent c_kv (kv_lora_rank) plus a shared
decoupled-RoPE key k_rope; per-head K/V are re-expanded with the up
projections k_up/v_up.  The paged cache stores only (c_kv, k_rope) —
the MLA memory win.  The up projections are float matmuls at every
precision, as in the JAX package (``_expand_kv`` calls ``dense`` at
"bf16"): only q, kv_down and o are binarized.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import attn_block
from repro_torch.layers import common as C


def init(gen: torch.Generator, cfg, dtype=torch.float32, device=None) -> dict:
    """cfg fields: d_model, n_heads, kv_lora_rank, qk_nope_head_dim,
    qk_rope_head_dim, v_head_dim, (optional) q_lora_rank."""
    h = cfg.n_heads
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    kw = dict(dtype=dtype, device=device)
    p = {}
    if cfg.q_lora_rank:
        p["q_down"] = C.dense_init(gen, cfg.d_model, cfg.q_lora_rank, **kw)
        p["q_up"] = C.dense_init(gen, cfg.q_lora_rank, h * qk_head, **kw)
    else:
        p["q"] = C.dense_init(gen, cfg.d_model, h * qk_head, **kw)
    p["kv_down"] = C.dense_init(
        gen, cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim, **kw)
    p["k_up"] = C.dense_init(gen, cfg.kv_lora_rank,
                             h * cfg.qk_nope_head_dim, **kw)
    p["v_up"] = C.dense_init(gen, cfg.kv_lora_rank, h * cfg.v_head_dim, **kw)
    p["o"] = C.dense_init(gen, h * cfg.v_head_dim, cfg.d_model, **kw)
    return p


def _project(params, cfg, x, positions, precision, impl, taps=None):
    """q_nope, q_rope (roped), the c_kv latent and k_rope (roped, one
    head shared by all) for tokens x."""
    b, t, _ = x.shape
    h = cfg.n_heads
    if cfg.q_lora_rank:
        q = C.dense(C.dense(x, params["q_down"], precision, impl, taps,
                            "q_down"),
                    params["q_up"], precision, impl, taps, "q_up")
    else:
        q = C.dense(x, params["q"], precision, impl, taps, "q")
    q = q.reshape(b, t, h, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = C.apply_rope(q[..., cfg.qk_nope_head_dim:], positions,
                          cfg.rope_theta)
    kv = C.dense(x, params["kv_down"], precision, impl, taps, "kv_down")
    c_kv = kv[..., :cfg.kv_lora_rank]
    k_rope = kv[..., cfg.kv_lora_rank:]
    k_rope = C.apply_rope(k_rope[:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _expand_kv(params, cfg, c_kv, k_rope):
    """Re-expand the latent to per-head K (nope ++ rope) and V."""
    b, s, _ = c_kv.shape
    h = cfg.n_heads
    k_nope = C.dense(c_kv, params["k_up"], "bf16").reshape(
        b, s, h, cfg.qk_nope_head_dim)
    v = C.dense(c_kv, params["v_up"], "bf16").reshape(b, s, h, cfg.v_head_dim)
    k_rope_b = k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def forward(params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
            precision: str = "bf16", window=None,
            impl: str = "auto") -> torch.Tensor:
    """Full-sequence MLA block."""
    b, t, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _project(params, cfg, x, positions,
                                            precision, impl)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k, v = _expand_kv(params, cfg, c_kv, k_rope)
    o = attn_mod.attention(q, k, v, causal=True, window=window)
    o = o.reshape(b, t, cfg.n_heads * cfg.v_head_dim)
    return C.dense(o, params["o"], precision, impl)


# ---------------------------------------------------------------------------
# block-paged latent cache (serving engine; see repro_torch/serving/).
# The block-table machinery is the GQA pool's (attn_block.scatter_blocks
# is shape-generic); each block holds the COMPRESSED latents, per token
# kv_lora_rank + qk_rope_head_dim floats instead of 2 * H * Dh.  The
# kernel decompresses per-head K/V at read time.


def init_paged_state(cfg, num_blocks: int, block_size: int,
                     dtype=torch.float32, device=None) -> dict:
    """Per-layer paged latent pool (the MLA mixer-state layout)."""
    kw = dict(dtype=dtype, device=device)
    return {"c_kv": torch.zeros((num_blocks, block_size, cfg.kv_lora_rank),
                                **kw),
            "k_rope": torch.zeros((num_blocks, block_size,
                                   cfg.qk_rope_head_dim), **kw)}


def _paged_attend(params, cfg, q, cache, block_table, lengths, kv_len,
                  newest, ring, causal, impl):
    """MLA paged attention: the kernel gathers the latents by block
    table and decompresses K/V itself."""
    return kops.paged_attention_mla(
        q.float().contiguous(), cache["c_kv"], cache["k_rope"], block_table,
        k_up=params["k_up"]["w"].float().contiguous(),
        v_up=params["v_up"]["w"].float().contiguous(),
        nope_dim=cfg.qk_nope_head_dim, kv_len=kv_len, q_offset=lengths,
        causal=causal, window=cfg.sliding_window, ring=ring,
        newest=newest.to(torch.int32).contiguous() if ring else None,
        impl=impl).to(q.dtype)


def _write_latents(cache, block_table, positions, c_kv, k_rope, valid, ring):
    attn_block.scatter_blocks(cache["c_kv"], block_table, positions, c_kv,
                              valid, ring=ring)
    attn_block.scatter_blocks(cache["k_rope"], block_table, positions,
                              k_rope, valid, ring=ring)


def paged_decode_step(params, cfg, x: torch.Tensor, cache,
                      block_table: torch.Tensor, lengths: torch.Tensor, *,
                      precision: str = "bf16",
                      active: torch.Tensor | None = None,
                      ring: bool = False, impl: str = "auto",
                      taps: list | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode against the paged latent pool, per-row lengths
    (arguments as ``attn_block.paged_decode_step``, ``taps`` as in
    ``prefill_chunk``); the pools are updated in place."""
    b = x.shape[0]
    positions = lengths[:, None].long()
    q_nope, q_rope, c_kv, k_rope = _project(params, cfg, x, positions,
                                            precision, impl, taps)
    valid = (torch.ones((b, 1), dtype=torch.bool, device=x.device)
             if active is None else active[:, None])
    _write_latents(cache, block_table, positions, c_kv, k_rope, valid, ring)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = _paged_attend(params, cfg, q, cache, block_table, lengths,
                      lengths + 1, lengths, ring, causal=False, impl=impl)
    o = o.reshape(b, 1, cfg.n_heads * cfg.v_head_dim)
    return C.dense(o, params["o"], precision, impl, taps, "o"), cache


def prefill_chunk(params, cfg, x: torch.Tensor, cache,
                  block_table: torch.Tensor, lengths: torch.Tensor,
                  n_valid: torch.Tensor, *, precision: str = "bf16",
                  ring: bool = False, impl: str = "auto",
                  taps: list | None = None) -> tuple[torch.Tensor, dict]:
    """Chunked prefill of C latent tokens per row at per-row offsets
    (arguments as ``attn_block.prefill_chunk``; ``taps`` receives
    ``(name, input)`` of q, kv_down and o)."""
    b, ch, _ = x.shape
    ar = torch.arange(ch, device=x.device)
    positions = lengths[:, None].long() + ar[None, :]
    q_nope, q_rope, c_kv, k_rope = _project(params, cfg, x, positions,
                                            precision, impl, taps)
    valid = ar[None, :] < n_valid[:, None]
    _write_latents(cache, block_table, positions, c_kv, k_rope, valid, ring)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = _paged_attend(params, cfg, q, cache, block_table, lengths,
                      lengths + n_valid, lengths + n_valid - 1, ring,
                      causal=True, impl=impl)
    o = o.reshape(b, ch, cfg.n_heads * cfg.v_head_dim)
    return C.dense(o, params["o"], precision, impl, taps, "o"), cache
