"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

KV are compressed to a low-rank latent c_kv (kv_lora_rank) plus a shared
decoupled-RoPE key k_rope; per-head K/V are re-expanded with the up
projections k_up/v_up.  The paged cache stores only (c_kv, k_rope) —
the MLA memory win.  The up projections are float matmuls at every
precision, as in the JAX package (``_expand_kv`` calls ``dense`` at
"bf16"): only q, kv_down and o are binarized.

Over a mesh (the params DTensors: ``dist/sharding.place_params``) the
block is tensor-parallel by heads: q is a column-parallel GEMM (the
rank's heads), kv_down is replicated (every rank computes the whole
latent and the shared k_rope of its rows), and o is a row-parallel
GEMM.  The JAX package places k_up and v_up by latent rows
(``("kv_lora", "heads")``: ``kv_lora`` wins the dedup over ``heads``),
and so does the port; but the kernel absorbs k_up into the query and
takes the softmax over the latent scores in one launch, so a cut of
the latent would need a reduction inside the softmax.  So at first use
each rank gathers k_up and v_up over ``model`` once, keeps the columns
of its heads (cached under the weight, as ``kernels/ops`` caches a
packed weight) and attends with its heads over the whole latent.  The
latent pools are whole on every rank (``sharding.state_rules_of``; the
JAX package's ``cache_specs`` cut them by ``kv_lora``): each rank
writes every row's latents (gathered over the data axis, as the GQA
pools are) and reads its rows'.
"""
from __future__ import annotations

import torch

from repro_torch.dist import spmd
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


def specs(cfg) -> dict:
    """Logical axes of ``init``'s leaves."""
    s = {}
    if cfg.q_lora_rank:
        s["q_down"] = C.dense_specs(("embed", "q_lora"))
        s["q_up"] = C.dense_specs(("q_lora", "heads"))
    else:
        s["q"] = C.dense_specs(("embed", "heads"))
    s["kv_down"] = C.dense_specs(("embed", None))
    s["k_up"] = C.dense_specs(("kv_lora", "heads"))
    s["v_up"] = C.dense_specs(("kv_lora", "heads"))
    s["o"] = C.dense_specs(("heads", "embed"))
    return s


def cache_specs() -> dict:
    """Logical axes of ``init_cache``'s latents."""
    return {"c_kv": ("batch", None, "kv_lora"),
            "k_rope": ("batch", None, None)}


def _cat(a, b):
    """[a ++ b] along the last dim (the rank's shards, placed as a)."""
    return spmd.on_local(lambda x, y: torch.cat([x, y], dim=-1), a, b)


def _project(params, cfg, x, positions, precision, impl, taps=None):
    """q_nope, q_rope (roped; the rank's heads over a mesh), the c_kv
    latent and k_rope (roped, one head shared by all) for tokens x."""
    nope, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    if cfg.q_lora_rank:
        q = C.dense(C.dense(x, params["q_down"], precision, impl, taps,
                            "q_down"),
                    params["q_up"], precision, impl, taps, "q_up")
    else:
        q = C.dense(x, params["q"], precision, impl, taps, "q")
    q = attn_block._heads(q, nope + cfg.qk_rope_head_dim)
    q_nope = spmd.on_local(lambda t: t[..., :nope], q)
    q_rope = spmd.on_local(lambda t, p: C.apply_rope(
        t[..., nope:], p, cfg.rope_theta), q, spmd.rows(positions, q))
    kv = C.dense(x, params["kv_down"], precision, impl, taps, "kv_down")
    c_kv = spmd.on_local(lambda t: t[..., :r], kv)
    k_rope = spmd.on_local(lambda t, p: C.apply_rope(
        t[..., r:][:, :, None, :], p, cfg.rope_theta)[:, :, 0],
        kv, spmd.rows(positions, kv))
    return q_nope, q_rope, c_kv, k_rope


def _up(params, name: str, q) -> torch.Tensor:
    """The float up projection ``name`` (k_up or v_up) for the heads
    ``q`` holds: the weight itself on one rank; over a mesh the whole
    weight's columns of the rank's heads, gathered once and cached
    under the weight (module docstring)."""
    w = params[name]["w"]
    if q is None or not spmd.is_dtensor(w):
        return w
    h0, hl = spmd.rank_slice(q, 2)
    n = w.shape[1] // q.shape[2]
    return kops.cached_per_weight(
        w, ("mla_heads", h0, hl),
        lambda wd: spmd.full(wd)[:, h0 * n:(h0 + hl) * n].contiguous())


def _expand_kv(params, cfg, c_kv, k_rope, q=None):
    """Re-expand the latent to per-head K (nope ++ rope) and V for the
    heads ``q`` holds (every head without ``q``; ``c_kv``, ``k_rope``:
    plain, the rank's rows)."""
    b, s, _ = c_kv.shape
    h = cfg.n_heads if q is None else spmd.local(q).shape[2]
    k_nope = C.dense(c_kv, {"w": _up(params, "k_up", q)}, "bf16").reshape(
        b, s, h, cfg.qk_nope_head_dim)
    v = C.dense(c_kv, {"w": _up(params, "v_up", q)}, "bf16").reshape(
        b, s, h, cfg.v_head_dim)
    k_rope_b = k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def _merge_heads(o: torch.Tensor, q):
    """The attention output (B, T, h, Dv) of ``q``'s rows and heads as
    (B, T, h*Dv), placed as ``q`` is (heads over ``model``)."""
    return spmd.wrap_like(o.reshape(*o.shape[:2], -1), q)


def forward(params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
            precision: str = "bf16", window=None,
            impl: str = "auto") -> torch.Tensor:
    """Full-sequence MLA block."""
    q_nope, q_rope, c_kv, k_rope = _project(params, cfg, x, positions,
                                            precision, impl)
    q = _cat(q_nope, q_rope)
    k, v = _expand_kv(params, cfg, spmd.local(c_kv), spmd.local(k_rope), q)
    o = attn_mod.attention(spmd.local(q), k, v, causal=True, window=window)
    return C.dense(_merge_heads(o, q), params["o"], precision, impl)


# ---------------------------------------------------------------------------
# dense per-batch latent cache (the legacy decode loop)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
               device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), **kw),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  **kw)}


def decode_step(params, cfg, x: torch.Tensor, cache, length: int, *,
                precision: str = "bf16", impl: str = "auto"
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode at position ``length``: the latents are written
    in place, then the whole cache is decompressed (``_expand_kv``) and
    attended causally up to ``length``.  x (B, 1, d).  Over a mesh the
    cache holds the rank's rows, as ``c_kv`` does (both placed by the
    batch axis)."""
    b = x.shape[0]
    positions = torch.full((b, 1), length, dtype=torch.long,
                           device=x.device)
    q_nope, q_rope, c_kv, k_rope = _project(params, cfg, x, positions,
                                            precision, impl)
    ck, kr = spmd.local(cache["c_kv"]), spmd.local(cache["k_rope"])
    ck[:, length] = spmd.local(c_kv)[:, 0]
    kr[:, length] = spmd.local(k_rope)[:, 0]
    q = _cat(q_nope, q_rope)
    k, v = _expand_kv(params, cfg, ck, kr, q)
    o = attn_mod.attention(spmd.local(q), k, v, causal=True,
                           q_offset=length, kv_len=length + 1)
    return C.dense(_merge_heads(o, q), params["o"], precision, impl), cache


# ---------------------------------------------------------------------------
# block-paged latent cache (serving engine; see repro_torch/serving/).
# The block-table machinery is the GQA pool's (attn_block.scatter_blocks
# is shape-generic); each block holds the COMPRESSED latents, per token
# kv_lora_rank + qk_rope_head_dim floats instead of 2 * H * Dh.  The
# kernel decompresses per-head K/V at read time.


def init_paged_state(cfg, num_blocks: int, block_size: int,
                     dtype=torch.float32, device=None) -> dict:
    """Per-layer paged latent pool (the MLA mixer-state layout).  Over a
    mesh the model places it by ``paged_state_specs``
    (``transformer.init_paged_state``)."""
    kw = dict(dtype=dtype, device=device)
    return {"c_kv": torch.zeros((num_blocks, block_size, cfg.kv_lora_rank),
                                **kw),
            "k_rope": torch.zeros((num_blocks, block_size,
                                   cfg.qk_rope_head_dim), **kw)}


def paged_state_specs() -> dict:
    """Logical axes of ``init_paged_state``'s (num_blocks, bs, ...)
    latent pools: ``cache_specs``' with the block axis in the batch's
    place, never sharded (a block id is global)."""
    return {"c_kv": (None, None, "kv_lora"), "k_rope": (None, None, None)}


def _paged_attend(params, cfg, q, cache, block_table, lengths, kv_len,
                  newest, ring, causal, impl):
    """MLA paged attention: the kernel gathers the latents by block
    table and decompresses K/V itself.  Over a mesh, on the rank's rows
    and heads against the whole latent pools."""
    def rows(t):
        return spmd.rows(t, q)
    ql = spmd.local(q)
    o = kops.paged_attention_mla(
        ql.float().contiguous(), spmd.local(cache["c_kv"]),
        spmd.local(cache["k_rope"]), rows(block_table),
        k_up=_up(params, "k_up", q).float().contiguous(),
        v_up=_up(params, "v_up", q).float().contiguous(),
        nope_dim=cfg.qk_nope_head_dim, kv_len=rows(kv_len),
        q_offset=rows(lengths), causal=causal, window=cfg.sliding_window,
        ring=ring,
        newest=rows(newest).to(torch.int32).contiguous() if ring else None,
        route_heads=cfg.n_heads, impl=impl).to(ql.dtype)
    return _merge_heads(o, q)


def _write_latents(cache, block_table, positions, c_kv, k_rope, valid, ring):
    """Every row's latents into the pools, in place (over a mesh every
    rank writes all rows: they are gathered over the data axis)."""
    for name, t in (("c_kv", c_kv), ("k_rope", k_rope)):
        attn_block.scatter_blocks(spmd.local(cache[name]), block_table,
                                  positions, spmd.local(spmd.all_rows(t)),
                                  valid, ring=ring)


def paged_decode_step(params, cfg, x: torch.Tensor, cache,
                      block_table: torch.Tensor, lengths: torch.Tensor, *,
                      precision: str = "bf16",
                      active: torch.Tensor | None = None,
                      ring: bool = False, impl: str = "auto",
                      attn_impl: str | None = None,
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
    o = _paged_attend(params, cfg, _cat(q_nope, q_rope), cache, block_table,
                      lengths, lengths + 1, lengths, ring, causal=False,
                      impl=attn_impl or impl)
    return C.dense(o, params["o"], precision, impl, taps, "o"), cache


def prefill_chunk(params, cfg, x: torch.Tensor, cache,
                  block_table: torch.Tensor, lengths: torch.Tensor,
                  n_valid: torch.Tensor, *, precision: str = "bf16",
                  ring: bool = False, impl: str = "auto",
                  attn_impl: str | None = None,
                  taps: list | None = None) -> tuple[torch.Tensor, dict]:
    """Chunked prefill of C latent tokens per row at per-row offsets
    (arguments as ``attn_block.prefill_chunk``; ``taps`` receives
    ``(name, input)`` of q, kv_down and o)."""
    ar = torch.arange(x.shape[1], device=x.device)
    positions = lengths[:, None].long() + ar[None, :]
    q_nope, q_rope, c_kv, k_rope = _project(params, cfg, x, positions,
                                            precision, impl, taps)
    valid = ar[None, :] < n_valid[:, None]
    _write_latents(cache, block_table, positions, c_kv, k_rope, valid, ring)
    o = _paged_attend(params, cfg, _cat(q_nope, q_rope), cache, block_table,
                      lengths, lengths + n_valid, lengths + n_valid - 1,
                      ring, causal=True, impl=attn_impl or impl)
    return C.dense(o, params["o"], precision, impl, taps, "o"), cache
