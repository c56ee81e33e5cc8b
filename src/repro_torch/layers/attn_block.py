"""GQA attention block: QKV/O projections + RoPE around the attention
core, over a full sequence (``forward``), the dense per-batch cache of
the legacy decode loop (``init_cache`` / ``decode_step``) or the
block-paged KV cache of the serving engine (``paged_decode_step`` /
``prefill_chunk``).

Over a mesh (the params DTensors: ``dist/sharding.place_params``) the
block is tensor-parallel by heads: q, k and v are column-parallel
GEMMs, so a rank holds its heads and its kv heads, its attention runs
on them against its kv-head slice of the pools (or of the dense
cache), and o is a row-parallel GEMM.  The rows a rank holds (data
parallel over the batch, ``lsc``) attend alone; their K and V are
gathered over the data axis before the pool write, since the pools
hold every block on every data rank (a block id is global).

Where a head count does not divide the model axis the JAX package's
decode rules cut the weight's columns inside a head (``head_dim`` over
``model``: reduced mixtral's one kv head, llama's 24 heads on a 16-way
axis).  The port keeps that placement of the weights and gathers such
a projection over ``model`` to whole heads before RoPE (it rotates
pairs spread over the head, and a rank's slice is not a head).  Where
the kv heads do not divide, every model rank then holds all of them,
in the pools too (``sharding.state_rules_of``), and attends with every
head: q is gathered whole as well, so each rank runs one rank's
attention, and o's row-parallel GEMM takes the rank's slice of its
output."""
from __future__ import annotations

import torch

from repro_torch.dist import spmd
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


def specs(cfg) -> dict:
    """Logical axes of ``init``'s leaves."""
    return {"q": C.dense_specs(("embed", "heads"), cfg.qkv_bias),
            "k": C.dense_specs(("embed", "kv_heads"), cfg.qkv_bias),
            "v": C.dense_specs(("embed", "kv_heads"), cfg.qkv_bias),
            "o": C.dense_specs(("heads", "embed"))}


def cache_specs() -> dict:
    """Logical axes of ``init_cache``'s (B, L, Hkv, Dh) K and V."""
    axes = ("batch", None, "kv_heads_dim", "head_dim")
    return {"k": axes, "v": axes}


def paged_state_specs() -> dict:
    """Logical axes of ``init_paged_state``'s (num_blocks, bs, Hkv, Dh)
    pools: ``cache_specs``' with the block axis in the batch's place,
    never sharded (a block id is global)."""
    axes = (None, None, "kv_heads_dim", "head_dim")
    return {"k": axes, "v": axes}


def _heads(y, dh: int):
    """(B, T, n*Dh) -> (B, T, n, Dh), a rank's n of its shard; a
    projection cut inside a head is gathered to whole heads first."""
    if (y.shape[-1] // dh) % spmd.shards(y, y.ndim - 1):
        y = spmd.whole(y, y.ndim - 1)
    return spmd.on_local(lambda t: t.reshape(*t.shape[:-1], -1, dh), y)


def _merge_heads(o):
    """(B, T, n, Dh) -> (B, T, n*Dh)."""
    return spmd.on_local(lambda t: t.reshape(*t.shape[:-2], -1), o)


def _qkv(params, cfg, x, positions, precision, impl, taps=None):
    q, k, v = (_heads(C.dense(x, params[n], precision, impl, taps, n),
                      cfg.head_dim) for n in ("q", "k", "v"))
    pos = spmd.rows(positions, q)
    q = spmd.on_local(C.apply_rope, q, pos, cfg.rope_theta)
    k = spmd.on_local(C.apply_rope, k, pos, cfg.rope_theta)
    # head-sharding where the kv heads divide the 'model' axis; else
    # every head on every model rank (module docstring), where the JAX
    # package splits head_dim
    split = spmd.is_dtensor(k) and spmd.shards(k, 2) > 1
    q = C.lsc(q, "batch", None, "heads_dim" if split else None, None)
    k = C.lsc(k, "batch", None, "kv_heads_dim" if split else None, None)
    v = C.lsc(v, "batch", None, "kv_heads_dim" if split else None, None)
    return q, k, v


def forward(params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
            precision: str = "bf16", impl: str = "auto") -> torch.Tensor:
    q, k, v = _qkv(params, cfg, x, positions, precision, impl)
    o = spmd.on_local(attn_mod.attention, q, k, v, causal=True,
                      window=cfg.sliding_window, q_chunk=cfg.q_chunk,
                      kv_chunk=cfg.kv_chunk)
    return C.dense(_merge_heads(o), params["o"], precision, impl)


# ---------------------------------------------------------------------------
# dense per-batch KV cache (the legacy decode loop, the engine's oracle)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
               device=None) -> dict:
    """(B, L, Hkv, Dh) K and V; a sliding-window config keeps a
    window-sized ring (L = min(max_len, window)).  Over a mesh the
    model places them by ``cache_specs``
    (``transformer.init_cache``)."""
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params, cfg, x: torch.Tensor, cache, length: int, *,
                precision: str = "bf16", impl: str = "auto"
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode at position ``length`` (one scalar for the whole
    batch); the cache's K/V are written in place at slot ``length``
    (``length % L`` for a sliding-window ring).  x (B, 1, d)."""
    b = x.shape[0]
    positions = torch.full((b, 1), length, dtype=torch.long,
                           device=x.device)
    q, k, v = _qkv(params, cfg, x, positions, precision, impl)
    # a rank's cache rows and kv heads are those of its k and v (both
    # placed by the batch and kv-head axes)
    ck, cv = spmd.local(cache["k"]), spmd.local(cache["v"])
    size = ck.shape[1]
    slot = length % size if cfg.sliding_window else length
    ck[:, slot] = spmd.local(k)[:, 0].to(ck.dtype)
    cv[:, slot] = spmd.local(v)[:, 0].to(cv.dtype)
    # a ring holds the last `window` tokens: attending over all valid
    # slots with no causal mask within them is the same attention
    o = spmd.on_local(lambda ql: attn_mod.attention(
        ql, ck.to(ql.dtype), cv.to(ql.dtype), causal=False,
        kv_len=min(length + 1, size), q_chunk=1, kv_chunk=cfg.kv_chunk), q)
    return C.dense(_merge_heads(o), params["o"], precision, impl), cache


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
    """Per-layer paged KV pool (the GQA mixer-state layout).  Over a
    mesh the model places it by ``paged_state_specs``
    (``transformer.init_paged_state``)."""
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


def _write_kv(cache, block_table, positions, k, v, valid, ring):
    """Every row's K and V into the pools, in place (over a mesh each
    rank writes its kv-head slice of all rows: the rows are gathered
    over the data axis first)."""
    for name, t in (("k", k), ("v", v)):
        scatter_blocks(spmd.local(cache[name]), block_table, positions,
                       spmd.local(spmd.all_rows(t)), valid, ring=ring)


def _paged_attend(cfg, q, cache, block_table, lengths, kv_len, newest,
                  ring, causal, impl):
    """GQA paged attention: the kernel walks the block table itself
    (``newest`` (B,), the highest position written, places the ring's
    slots).  Over a mesh, on the rank's rows and heads."""
    def rows(t):
        return spmd.rows(t, q)
    ql = spmd.local(q)
    o = kops.paged_attention(
        ql.float().contiguous(), spmd.local(cache["k"]),
        spmd.local(cache["v"]), rows(block_table), kv_len=rows(kv_len),
        q_offset=rows(lengths), causal=causal, window=cfg.sliding_window,
        ring=ring,
        newest=rows(newest).to(torch.int32).contiguous() if ring else None,
        impl=impl).to(ql.dtype)
    return spmd.wrap_like(o, q)


def paged_decode_step(params, cfg, x: torch.Tensor, cache,
                      block_table: torch.Tensor, lengths: torch.Tensor, *,
                      precision: str = "bf16",
                      active: torch.Tensor | None = None,
                      ring: bool = False, impl: str = "auto",
                      attn_impl: str | None = None,
                      taps: list | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode against the paged pool with PER-ROW lengths.

    x (B, 1, d); block_table (B, max_blocks) int32; lengths (B,) int32
    current per-sequence cache fill; active (B,) bool masks padded batch
    slots; ring=True treats the table as a sliding-window ring.  The
    pools in ``cache`` are updated in place.  ``taps`` as in
    ``prefill_chunk``.  The paged attention resolves ``attn_impl``
    (``None``: the projections' ``impl``), the BNN projections ``impl``.
    """
    b = x.shape[0]
    positions = lengths[:, None].long()                          # (B, 1)
    q, k, v = _qkv(params, cfg, x, positions, precision, impl, taps)
    valid = (torch.ones((b, 1), dtype=torch.bool, device=x.device)
             if active is None else active[:, None])
    _write_kv(cache, block_table, positions, k, v, valid, ring)
    o = _paged_attend(cfg, q, cache, block_table, lengths, lengths + 1,
                      lengths, ring, causal=False,
                      impl=attn_impl or impl)
    return C.dense(_merge_heads(o), params["o"], precision, impl, taps,
                   "o"), cache


def prefill_chunk(params, cfg, x: torch.Tensor, cache,
                  block_table: torch.Tensor, lengths: torch.Tensor,
                  n_valid: torch.Tensor, *, precision: str = "bf16",
                  ring: bool = False, impl: str = "auto",
                  attn_impl: str | None = None,
                  taps: list | None = None) -> tuple[torch.Tensor, dict]:
    """Chunked prefill: C tokens per row appended at per-row offsets.

    x (B, C, d); lengths (B,) tokens already cached; n_valid (B,) how
    many of the C chunk positions are real (the rest are padding).
    Causal within the chunk, full (or window-masked) attention to the
    cached prefix; ring=True as in ``paged_decode_step``.  The pools in
    ``cache`` are updated in place.  ``taps``, when a list, receives
    ``(name, input)`` of each projection (q, k, v, o).
    """
    ar = torch.arange(x.shape[1], device=x.device)
    positions = lengths[:, None].long() + ar[None, :]
    q, k, v = _qkv(params, cfg, x, positions, precision, impl, taps)
    valid = ar[None, :] < n_valid[:, None]
    _write_kv(cache, block_table, positions, k, v, valid, ring)
    o = _paged_attend(cfg, q, cache, block_table, lengths,
                      lengths + n_valid, lengths + n_valid - 1, ring,
                      causal=True, impl=attn_impl or impl)
    return C.dense(_merge_heads(o), params["o"], precision, impl, taps,
                   "o"), cache
