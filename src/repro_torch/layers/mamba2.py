"""Mamba-2 block (state-space duality / SSD, arXiv:2405.21060).

Chunked SSD: the sequence is split into chunks of length L; within a
chunk the recurrence is computed as a masked quadratic form (the dual of
attention), each chunk's boundary state is folded into the next by a
scan over chunks, and the inter-chunk contribution is added back.
Single-token decode is the O(1) recurrence on the cached state.

Shapes per block: x (B, T, d_model); d_inner = expand * d_model;
heads H = d_inner / headdim P; state N = d_state; groups G (= 1 here).

Order of the sums (the JAX package's XLA may associate otherwise; the
two agree to float32 rounding): every sum over chunk positions (the
intra-chunk product, the chunk states) is one batched matmul; the
three-operand products are two contractions, the position-wise product
first, so no (L, H, N) intermediate is built; the inter-chunk scan is a
loop over chunks in order, state_c = state_{c-1} * exp(total_c) +
S_c, where the JAX package runs an associative scan.

The SSD, the depthwise conv and the recurrence are plain torch ops, as
they are plain jnp in the JAX package; ``in_proj`` and ``out_proj`` go
through ``common.dense`` (the fused BNN GEMM at precision "bnn").  Each
head's sums are a matmul a head (``_intra``, ``_states``, ``_readout``;
a decode step's read-out of the state a product summed over N), so a
head rounds alike whatever heads run beside it.

Over a mesh (the params DTensors: ``dist/sharding.place_params``) the
block runs on the rank's heads, under the JAX package's placements,
which cut across the block's structure: ``in_proj``'s columns
(z | x B C | dt) and the conv channels (x | B | C) over ``model``, the
norm's scale over d_inner, ``out_proj``'s rows; A_log, D and dt_bias
replicated.  ``in_proj`` runs column-parallel (the fused GEMM on the
rank's columns, exact per column: alpha is a column's) and its output
is gathered over ``model`` (a concatenation, exact), so each rank slices
z, x and dt of its heads and B and C whole (G = 1: every head reads
them).  The conv weight and bias and the norm's scale are gathered
whole once and cached under the weight (``_whole``); the depthwise conv
runs on the rank's x channels and B and C, the SSD on its heads.  The
gated RMSNorm is over the whole d_inner, so y is gathered over
``model`` to whole rows and each rank normalizes its own rows
(``kernels/ops.row_norm``: a row's bits are one rank's), and
``out_proj`` is row-parallel on the rank's slice (the integer dot
summed over ``model``, then alpha).  The slot pools hold the rank's
heads of ``h`` and the whole conv tail of every slot on every data rank
(``sharding.state_rules_of``): the new state of the rank's rows is
gathered over ``data`` before the slot write (``_write_rows``), as the
GQA pools' K and V are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import spmd
from repro_torch.kernels import ops as kops
from repro_torch.layers import common as C

MASKED = -1e30      # exponent of a masked (s > t) pair, set BEFORE exp


def _dims(cfg) -> tuple[int, int, int, int]:
    """(d_inner, heads, state, conv channels)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return (d_inner, d_inner // cfg.ssm_headdim, cfg.ssm_state,
            d_inner + 2 * cfg.ssm_state)


def init(gen: torch.Generator, cfg, dtype=torch.float32, device=None) -> dict:
    """cfg fields: d_model, ssm_expand, ssm_headdim, ssm_state, ssm_conv.
    Same distributions as the JAX package's init."""
    d_inner, h, n, conv_ch = _dims(cfg)
    kw = dict(dtype=dtype, device=device)
    p = {"in_proj": C.dense_init(gen, cfg.d_model, 2 * d_inner + 2 * n + h,
                                 **kw)}
    p["conv_w"] = torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                              **kw) * 0.2
    p["conv_b"] = torch.zeros((conv_ch,), **kw)
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, h, **kw))
    p["D"] = torch.ones((h,), **kw)
    p["dt_bias"] = torch.zeros((h,), **kw)
    p["norm"] = C.norm_init(d_inner, "rmsnorm", **kw)
    p["out_proj"] = C.dense_init(gen, d_inner, cfg.d_model, **kw)
    return p


def specs(cfg) -> dict:
    """Logical axes of ``init``'s leaves."""
    return {"in_proj": C.dense_specs(("embed", "ssm_inner")),
            "conv_w": (None, "ssm_inner"), "conv_b": ("ssm_inner",),
            "A_log": (None,), "D": (None,), "dt_bias": (None,),
            "norm": {"scale": ("ssm_inner",)},
            "out_proj": C.dense_specs(("ssm_inner", "embed"))}


def cache_specs() -> dict:
    """Logical axes of ``init_cache``'s state and conv tail."""
    return {"h": ("batch", "ssm_heads", None, None),
            "conv": ("batch", None, "ssm_inner")}


def paged_state_specs() -> dict:
    """Logical axes of ``init_paged_state``'s slot pools: ``cache_specs``'
    with the slot axis in the batch's place, never sharded (a slot id is
    global)."""
    return {"h": (None, "ssm_heads", None, None),
            "conv": (None, None, "ssm_inner")}


def _split_proj(cfg, zxbcdt: torch.Tensor):
    d_inner, h, n, conv_ch = _dims(cfg)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_ch, h], dim=-1)
    return z, xbc, dt, d_inner, h, 1, n


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: xbc (B, T, C), w (k, C)."""
    k, t = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + t, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b[None, None, :])


def _softplus_dt(params, dt: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt.float() + params["dt_bias"].float())


def _a(params) -> torch.Tensor:
    return -torch.exp(params["A_log"].float())                    # (H,)


# --------------------------------------------------------------- the heads


def _whole(w: torch.Tensor) -> torch.Tensor:
    """A parameter whole on every rank: a DTensor gathered once and
    cached under it (the conv weight and bias, the norm's scale; module
    docstring); a plain tensor as it is."""
    if not spmd.is_dtensor(w):
        return w
    return kops.cached_per_weight(w, ("ssm_whole",), spmd.full)


def _head_range(cfg, params, state=None) -> tuple[int, int, list[int]]:
    """(first head, heads, the mesh dims that cut them) this rank runs:
    those of its slice of ``state`` (a pool's or a cache's ``h``) where
    given, else the cut of ``in_proj``'s columns where the heads divide
    it; every head on one rank."""
    h = _dims(cfg)[1]
    if state is not None:
        start, n = spmd.rank_slice(state, 1)
        return start, n, spmd.mesh_dims(state, 1)
    w = params["in_proj"]["w"]
    dims = spmd.mesh_dims(w, 1)
    if not dims or h % math.prod(w.device_mesh.size(i) for i in dims):
        return 0, h, []
    coord, start, n = w.device_mesh.get_coordinate(), 0, h
    for i in dims:
        n //= w.device_mesh.size(i)
        start += coord[i] * n
    return start, n, dims


def _rank_channels(t: torch.Tensor, cfg, heads) -> torch.Tensor:
    """The conv channels (last dim of ``t``) of the rank's heads: their
    x channels, then B and C whole."""
    d_inner, h, _n, _ch = _dims(cfg)
    h0, hl, _ = heads
    if hl == h:
        return t
    p = cfg.ssm_headdim
    return torch.cat([t[..., h0 * p:(h0 + hl) * p], t[..., d_inner:]], -1)


def _in_proj(params, cfg, x, precision, impl, taps):
    """``in_proj`` of x's rows with whole columns (gathered over the mesh
    dims that cut the weight's: a concatenation, exact): (z, xbc, dt),
    plain tensors of the rank's rows."""
    y = C.dense(x, params["in_proj"], precision, impl, taps, "in_proj")
    y = spmd.local(spmd.whole(y, y.ndim - 1))
    d_inner, h, _n, conv_ch = _dims(cfg)
    return torch.split(y, [d_inner, conv_ch, h], dim=-1)


def _conv_params(params, cfg, heads):
    """(conv weight (k, ch), bias (ch,)) of the rank's channels."""
    return (_rank_channels(_whole(params["conv_w"]), cfg, heads),
            _rank_channels(_whole(params["conv_b"]), cfg, heads))


def _ssd_inputs(xbc1: torch.Tensor, cfg, heads):
    """The conv output (.., rank channels) as (x (.., hl, P), B, C)."""
    hl, n, p = heads[1], cfg.ssm_state, cfg.ssm_headdim
    xs, b_, c_ = torch.split(xbc1, [hl * p, n, n], dim=-1)
    return xs.reshape(*xs.shape[:-1], hl, p), b_, c_


def _head_params(params, heads):
    """(dt_bias, A = -exp(A_log), D) of the rank's heads, float32 (the
    three are replicated)."""
    sl = slice(heads[0], heads[0] + heads[1])

    def get(name):
        return spmd.local(params[name]).float()[sl]
    return get("dt_bias"), -torch.exp(get("A_log")), get("D")


def _whole_heads(y: torch.Tensor, x, heads):
    """``y`` (rows, T, hl·P), the rank's heads of ``x``'s rows, as a
    DTensor placed as ``x`` with whole rows of d_inner (gathered over
    the mesh dims that cut the heads); ``y`` itself off a mesh."""
    if not spmd.is_dtensor(x):
        return y
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(2) if i in heads[2] else
          (p if p.is_shard() and p.dim == 0 else Replicate())
          for i, p in enumerate(x.placements)]
    return spmd.whole(spmd.wrap(y, x.device_mesh, pl), 2)


def _gated_out(params, y, z, x, heads, precision, impl, taps):
    """rmsnorm(y) * silu(z) over the whole d_inner, then ``out_proj``.
    Over a mesh y (the rank's heads) is gathered to whole d_inner first
    and normalized on the rank's rows, and ``out_proj`` is row-parallel
    on the rank's slice."""
    y = _whole_heads(y, x, heads)
    scale = {"scale": _whole(params["norm"]["scale"])}
    y = spmd.on_local(lambda t: C.rmsnorm(t.to(x.dtype), scale), y)
    y = spmd.on_local(lambda t, zz: t * F.silu(zz), y, z)
    return C.dense(y, params["out_proj"], precision, impl, taps, "out_proj")


def _write_rows(cache, dst: torch.Tensor, new: dict, x):
    """The new state of ``x``'s rows into slots ``dst`` (every row's),
    in place.  Over a mesh every slot lives on every data rank, so the
    rows are gathered over the data dims that cut ``x``'s first; each
    rank writes its heads of ``h`` and the whole conv tail."""
    if spmd.is_dtensor(x) and spmd.shards(x, 0) > 1:
        from torch.distributed.tensor import Replicate
        pl = [p if p.is_shard() and p.dim == 0 else Replicate()
              for p in x.placements]
        new = {k: spmd.local(spmd.all_rows(spmd.wrap(v, x.device_mesh, pl)))
               for k, v in new.items()}
    _write_slots({k: spmd.local(v) for k, v in cache.items()}, dst, new)


# --------------------------------------------------- the SSD's contractions
#
# A head's sums run in a matmul (or a sum) whose shape does not hold the
# head count, so a rank holding some of the heads rounds each head as
# one rank does (a GEMM whose N is H·P picked another algorithm at H/2
# heads; PERF.md, ``chip_ranks_full.py --rows``).


def _intra(m: torch.Tensor, xdt: torch.Tensor) -> torch.Tensor:
    """sum_s m[.., l, s, h] xdt[.., s, h, p] -> (.., L, H, P): a matmul
    a head."""
    return torch.matmul(m.movedim(-1, -3), xdt.transpose(-2, -3)) \
        .transpose(-2, -3)


def _states(w_s: torch.Tensor, b_: torch.Tensor,
            xs: torch.Tensor) -> torch.Tensor:
    """sum_l w_s[.., l, h] B[.., l, n] x[.., l, h, p] -> (.., H, N, P):
    the weights times x first, then a matmul over l a head."""
    wx = w_s[..., None] * xs                                   # (.., L, H, P)
    return torch.matmul(b_.transpose(-1, -2)[..., None, :, :],
                        wx.transpose(-2, -3))


def _readout(c_: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """sum_n C[.., l, n] h[.., h, n, p] -> (.., L, H, P): a matmul a head;
    one position (decode) a product summed over n, since cuBLAS's
    batched matrix-vector product rounded a head by the head count."""
    if c_.shape[-2] == 1:
        return (c_[..., :, None, :, None] * hs[..., None, :, :, :]).sum(-2)
    return torch.matmul(c_[..., None, :, :], hs).transpose(-2, -3)


# --------------------------------------------------------------- forward


def forward(params, cfg, x: torch.Tensor, *, chunk: int = 256,
            precision: str = "bf16", impl: str = "auto") -> torch.Tensor:
    """Full-sequence SSD (prefill over a whole sequence), on the rank's
    heads over a mesh."""
    heads = _head_range(cfg, params)
    z, xbc, dt = _in_proj(params, cfg, x, precision, impl, None)
    bsz, t, _ = xbc.shape
    h, p = heads[1], cfg.ssm_headdim
    w, b = _conv_params(params, cfg, heads)
    # the scan in float32, as the JAX package promotes it
    xs, b_, c_ = (v.float() for v in _ssd_inputs(
        _causal_conv(_rank_channels(xbc, cfg, heads), w, b), cfg, heads))
    dt_bias, a, d = _head_params(params, heads)
    dt = F.softplus(dt[..., heads[0]:heads[0] + h].float() + dt_bias)
    log_decay = dt * a[None, None, :]                          # (B,T,H)

    lpad = (-t) % chunk
    if lpad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, lpad))
        b_ = F.pad(b_, (0, 0, 0, lpad))
        c_ = F.pad(c_, (0, 0, 0, lpad))
        dt = F.pad(dt, (0, 0, 0, lpad))
        log_decay = F.pad(log_decay, (0, 0, 0, lpad))
    tp = t + lpad
    nc = tp // chunk

    def ch(v, *trail):
        return v.reshape(bsz, nc, chunk, *trail)

    xs_c, b_c, c_c = ch(xs, h, p), ch(b_, cfg.ssm_state), \
        ch(c_, cfg.ssm_state)
    dt_c, ld_c = ch(dt, h), ch(log_decay, h)
    cum = torch.cumsum(ld_c, dim=2)                            # (B,nc,L,H)
    total = cum[:, :, -1]                                      # (B,nc,H)

    # intra-chunk (quadratic / attention-dual) form:
    # M[t,s] = (C_t . B_s) * exp(cum_t - cum_s) for s <= t
    cb = torch.einsum("bcln,bcsn->bcls", c_c, b_c)             # (B,nc,L,L)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nc,L,L,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xbc.device).tril()
    # masked BEFORE exp: for s > t the exponent is positive and can
    # overflow, and inf * 0 is NaN
    seg = torch.where(causal[None, None, :, :, None], seg, MASKED)
    m = cb[..., None] * torch.exp(seg)
    y_intra = _intra(m, xs_c * dt_c[..., None])                # (B,nc,L,H,P)

    # chunk boundary states S_c = sum_s exp(total - cum_s) dt_s B_s x_s
    w_s = torch.exp(total[:, :, None, :] - cum) * dt_c          # (B,nc,L,H)
    states = _states(w_s, b_c, xs_c)                           # (B,nc,H,N,P)

    # inter-chunk scan, in chunk order: the state entering chunk c
    decay_c = torch.exp(total)                                 # (B,nc,H)
    carry = torch.zeros_like(states[:, 0])
    h_prev = []
    for c in range(nc):
        h_prev.append(carry)
        carry = carry * decay_c[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # (B,nc,H,N,P)

    y_inter = _readout(c_c, h_prev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, tp, h, p)[:, :t]
    y = y + xs[:, :t] * d[None, None, :, None]
    return _gated_out(params, y.reshape(bsz, t, h * p), z, x, heads,
                      precision, impl, None)


def forward_reference(params, cfg, x: torch.Tensor, *,
                      precision: str = "bf16") -> torch.Tensor:
    """O(T) sequential reference (tests; one rank): the plain recurrence.
    The JAX package's runs float projections; ``precision`` picks the
    port's."""
    bsz, t, _ = x.shape
    zxbcdt = C.dense(x, params["in_proj"], precision)
    z, xbc, dt, d_inner, h, g, n = _split_proj(cfg, zxbcdt)
    p = cfg.ssm_headdim
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs, b_, c_ = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, t, h, p).float()
    b_ = b_.reshape(bsz, t, n).float()
    c_ = c_.reshape(bsz, t, n).float()
    dt = _softplus_dt(params, dt)
    decay = torch.exp(dt * _a(params)[None, None])             # (B,T,H)
    hs = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        upd = (dt[:, i, :, None] * xs[:, i])[:, :, None, :] * \
            b_[:, i, None, :, None]
        hs = hs * decay[:, i, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", c_[:, i], hs))
    y = torch.stack(ys, dim=1)
    y = y + xs * params["D"].float()[None, None, :, None]
    return _gated_out(params, y.reshape(bsz, t, d_inner), z, x,
                      (0, h, []), precision, "auto", None)


# ---------------------------------------------------------------------------
# token-by-token decode with a per-request cache


def init_cache(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    _d, h, n, conv_ch = _dims(cfg)
    return {"h": torch.zeros((batch, h, n, cfg.ssm_headdim), dtype=dtype,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=dtype, device=device)}


def _decode(params, cfg, x, hs: torch.Tensor, conv: torch.Tensor, heads,
            precision, impl, taps):
    """One token of x's rows from their state (plain tensors: ``hs`` the
    rank's heads, ``conv`` the whole tail): (out, new h, new conv)."""
    z, xbc, dt = _in_proj(params, cfg, x, precision, impl, taps)
    bsz = xbc.shape[0]
    w, b = _conv_params(params, cfg, heads)

    # conv with the cached history: the products summed tap by tap, as
    # prefill_chunk sums them
    hist = torch.cat([conv.to(xbc.dtype), xbc], dim=1)        # (B, k, ch)
    hr = _rank_channels(hist, cfg, heads)
    out = sum(hr[:, i:i + 1] * w[i][None, None] for i in range(w.shape[0]))
    xs, b_, c_ = _ssd_inputs(F.silu(out + b[None, None]), cfg, heads)
    xs, b_, c_ = xs[:, 0].float(), b_.float(), c_.float()  # (B,H,P), (B,1,N)
    dt_bias, a, d = _head_params(params, heads)
    h0, hl, _ = heads
    dt = F.softplus(dt[:, 0, h0:h0 + hl].float() + dt_bias)    # (B,H)
    decay = torch.exp(dt * a[None])

    upd = (dt[:, :, None] * xs)[:, :, None, :] * b_[:, 0, None, :, None]
    hstate = hs.float() * decay[:, :, None, None] + upd
    y = _readout(c_, hstate)[:, 0]                             # (B,H,P)
    y = y + xs * d[None, :, None]
    out = _gated_out(params, y.reshape(bsz, 1, hl * cfg.ssm_headdim), z, x,
                     heads, precision, impl, taps)
    return out, hstate, hist[:, 1:]


def decode_step(params, cfg, x: torch.Tensor, cache, *,
                precision: str = "bf16", impl: str = "auto",
                taps: list | None = None) -> tuple[torch.Tensor, dict]:
    """O(1) single-token step.  x (B, 1, d_model).  Returns (out, the new
    state); ``cache`` is not written.  Over a mesh the cache's rows are
    x's and its heads the rank's (``h``; the conv tail whole), and so
    are the new state's."""
    heads = _head_range(cfg, params, cache["h"])
    y, hstate, new_conv = _decode(params, cfg, x, spmd.local(cache["h"]),
                                  spmd.local(cache["conv"]), heads,
                                  precision, impl, taps)
    return y, {"h": spmd.wrap_like(hstate.to(cache["h"].dtype), cache["h"]),
               "conv": spmd.wrap_like(new_conv.to(cache["conv"].dtype),
                                      cache["conv"])}


# ---------------------------------------------------------------------------
# per-slot recurrent state (serving engine; see repro_torch/serving/)
#
# A request's whole mixer state is ONE fixed-size slot of the pool
# (SSD hidden state, conv tail): O(1) in sequence length, no block table.
# Slot 0 is scratch: the writes of padded rows go there and it is never
# read for a real row.  The pools are updated in place; a repeated index
# (padded rows all write slot 0) is harmless only because slot 0 is
# never read, so no write here accumulates.


def init_paged_state(cfg, num_slots: int, dtype=torch.float32,
                     device=None) -> dict:
    """Per-layer slot pool (the recurrent mixer-state layout)."""
    return init_cache(cfg, num_slots, dtype, device)


def _write_slots(cache, dst: torch.Tensor, new: dict):
    for k in ("h", "conv"):
        cache[k][dst.long()] = new[k].to(cache[k].dtype)


def copy_slot(dst_pool: dict, dst: int, src_pool: dict, src: int) -> dict:
    """Copy one slot's whole recurrent state (h, conv tail) between two
    slot pools of any row counts, in place: the prefix-snapshot store
    (a live slot into the snapshot pool) and restore (a snapshot row
    into the live pool).  Over a mesh, of the rank's slices."""
    for k, v in dst_pool.items():
        spmd.local(v)[dst].copy_(spmd.local(src_pool[k])[src])
    return dst_pool


def snapshot_slots(cache, slots: torch.Tensor) -> dict:
    """Each row's recurrent slot, copied before a multi-token verify so a
    partly rejected speculative step can be rolled back.  Advanced
    indexing returns a copy: the verify then updates the pools in
    place, and a view would change with them.  Over a mesh, the rank's
    slices of every row's slot (plain tensors)."""
    idx = slots.long()
    return {k: spmd.local(v)[idx] for k, v in cache.items()}


def restore_slots(cache, slots: torch.Tensor, snap: dict) -> dict:
    """Write per-row snapshots back into the slot pool, in place (the
    speculative rollback).  Padded rows all point at scratch slot 0 and
    carry the same snapshot of it, so a repeated index writes equal
    values and the unspecified order of ``index_put_`` on CUDA cannot
    matter."""
    _write_slots({k: spmd.local(v) for k, v in cache.items()}, slots, snap)
    return cache


def paged_decode_step(params, cfg, x: torch.Tensor, cache,
                      slots: torch.Tensor, *, precision: str = "bf16",
                      active: torch.Tensor | None = None,
                      impl: str = "auto", taps: list | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """O(1) decode against the slot pool, in place.  x (B, 1, d); slots
    (B,) slot ids; rows with ``active`` False write to scratch slot 0.
    ``taps`` as in ``prefill_chunk``."""
    idx = spmd.rows(slots, x).long()
    y, hstate, new_conv = _decode(
        params, cfg, x, spmd.local(cache["h"])[idx],
        spmd.local(cache["conv"])[idx], _head_range(cfg, params, cache["h"]),
        precision, impl, taps)
    dst = slots if active is None else torch.where(active, slots, 0)
    _write_rows(cache, dst, {"h": hstate, "conv": new_conv}, x)
    return y, cache


def prefill_chunk(params, cfg, x: torch.Tensor, cache, slots: torch.Tensor,
                  n_valid: torch.Tensor, *, precision: str = "bf16",
                  impl: str = "auto", taps: list | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Advance each row's slot state by one chunk of C tokens, in place.

    x (B, C, d); slots (B,); n_valid (B,) real tokens per row (the rest
    is padding, masked by zeroing dt, so padded steps neither decay nor
    update the state).  The single-chunk SSD dual form with the slot's
    carried state h0 folded in: y_t += C_t . h0 . exp(cum_t), and the
    state written is h0 . exp(total) + the chunk's boundary state.  A
    row with n_valid = 0 writes to scratch slot 0.  ``taps``, when a
    list, receives ``(name, input)`` of ``in_proj`` and ``out_proj``.
    """
    heads = _head_range(cfg, params, cache["h"])
    z, xbc, dt = _in_proj(params, cfg, x, precision, impl, taps)
    bsz, c_len, _ = xbc.shape
    w, b = _conv_params(params, cfg, heads)
    k = w.shape[0]
    idx = spmd.rows(slots, x).long()
    nv = spmd.rows(n_valid, x)

    # depthwise causal conv over the slot's carried (k-1)-token tail
    hist = spmd.local(cache["conv"])[idx].to(xbc.dtype)       # (B, k-1, ch)
    full = torch.cat([hist, xbc], dim=1)                       # (B, k-1+C, ch)
    fr = _rank_channels(full, cfg, heads)
    out = sum(fr[:, i:i + c_len] * w[i][None, None] for i in range(k))
    xbc1 = F.silu(out + b[None, None])
    # the new tail: the last k-1 inputs up to the row's valid length (for
    # n_valid < k-1 part of the old tail)
    tail = nv.long()[:, None] + torch.arange(k - 1, device=xbc.device)
    new_conv = torch.gather(
        full, 1, tail[:, :, None].expand(bsz, k - 1, full.shape[-1]))

    xs, b_, c_ = _ssd_inputs(xbc1, cfg, heads)
    xs, b_, c_ = xs.float(), b_.float(), c_.float()
    dt_bias, a, d = _head_params(params, heads)
    valid = torch.arange(c_len, device=xbc.device)[None, :] < nv[:, None]
    dt = F.softplus(dt[..., heads[0]:heads[0] + heads[1]].float()
                    + dt_bias) * valid[..., None]              # (B,C,H)
    cum = torch.cumsum(dt * a[None, None, :], dim=1)           # (B,C,H)
    total = cum[:, -1]                                         # (B,H)

    # intra-chunk quadratic (attention-dual) form
    cb = torch.einsum("bln,bsn->bls", c_, b_)
    seg = cum[:, :, None, :] - cum[:, None, :, :]              # (B,C,C,H)
    causal = torch.ones((c_len, c_len), dtype=torch.bool,
                        device=xbc.device).tril()
    seg = torch.where(causal[None, :, :, None], seg, MASKED)
    m = cb[..., None] * torch.exp(seg)
    y = _intra(m, xs * dt[..., None])

    # the carried state's contribution and the new boundary state
    h0 = spmd.local(cache["h"])[idx].float()                   # (B,H,N,P)
    y = y + _readout(c_, h0) * torch.exp(cum)[..., None]
    w_s = torch.exp(total[:, None, :] - cum) * dt              # (B,C,H)
    hstate = h0 * torch.exp(total)[:, :, None, None] + _states(w_s, b_, xs)

    y = y + xs * d[None, None, :, None]
    out = _gated_out(params, y.reshape(bsz, c_len, -1), z, x, heads,
                     precision, impl, taps)
    _write_rows(cache, torch.where(n_valid > 0, slots, 0),
                {"h": hstate, "conv": new_conv}, x)
    return out, cache
