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
through ``common.dense`` (the fused BNN GEMM at precision "bnn").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _gated_out(params, cfg, y, z, x_dtype, precision, impl, taps):
    """rmsnorm(y) * silu(z), then ``out_proj``."""
    y = C.rmsnorm(y.to(x_dtype), params["norm"]) * F.silu(z)
    return C.dense(y, params["out_proj"], precision, impl, taps, "out_proj")


def _states(w_s: torch.Tensor, b_: torch.Tensor,
            xs: torch.Tensor) -> torch.Tensor:
    """sum_l w_s[.., l, h] B[.., l, n] x[.., l, h, p] -> (.., H, N, P):
    the weights times x first, then one matmul over l."""
    wx = w_s[..., None] * xs                                   # (.., L, H, P)
    return torch.einsum("...ln,...lhp->...hnp", b_, wx)


def forward(params, cfg, x: torch.Tensor, *, chunk: int = 256,
            precision: str = "bf16", impl: str = "auto") -> torch.Tensor:
    """Full-sequence SSD (prefill over a whole sequence)."""
    bsz, t, _ = x.shape
    zxbcdt = C.dense(x, params["in_proj"], precision, impl)
    z, xbc, dt, d_inner, h, g, n = _split_proj(cfg, zxbcdt)
    p = cfg.ssm_headdim
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs, b_, c_ = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, t, h, p)
    b_ = b_.reshape(bsz, t, n)                                 # g = 1
    c_ = c_.reshape(bsz, t, n)
    dt = _softplus_dt(params, dt)                              # (B,T,H)
    log_decay = dt * _a(params)[None, None, :]

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

    xs_c, b_c, c_c = ch(xs, h, p), ch(b_, n), ch(c_, n)
    dt_c, ld_c = ch(dt, h), ch(log_decay, h)
    cum = torch.cumsum(ld_c, dim=2)                            # (B,nc,L,H)
    total = cum[:, :, -1]                                      # (B,nc,H)

    # intra-chunk (quadratic / attention-dual) form:
    # M[t,s] = (C_t . B_s) * exp(cum_t - cum_s) for s <= t
    cb = torch.einsum("bcln,bcsn->bcls", c_c, b_c)             # (B,nc,L,L)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nc,L,L,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    # masked BEFORE exp: for s > t the exponent is positive and can
    # overflow, and inf * 0 is NaN
    seg = torch.where(causal[None, None, :, :, None], seg, MASKED)
    m = cb[..., None] * torch.exp(seg)
    xdt = xs_c * dt_c[..., None]                               # (B,nc,L,H,P)
    y_intra = torch.einsum("bclsh,bcshp->bclhp", m, xdt)

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

    y_inter = torch.einsum("bcln,bchnp->bclhp", c_c, h_prev) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, tp, h, p)[:, :t]
    y = y + xs[:, :t] * params["D"].float()[None, None, :, None]
    return _gated_out(params, cfg, y.reshape(bsz, t, d_inner), z, x.dtype,
                      precision, impl, None)


def forward_reference(params, cfg, x: torch.Tensor, *,
                      precision: str = "bf16") -> torch.Tensor:
    """O(T) sequential reference (tests): the plain recurrence.  The JAX
    package's runs float projections; ``precision`` picks the port's."""
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
    return _gated_out(params, cfg, y.reshape(bsz, t, d_inner), z, x.dtype,
                      precision, "auto", None)


# ---------------------------------------------------------------------------
# token-by-token decode with a per-request cache


def init_cache(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    _d, h, n, conv_ch = _dims(cfg)
    return {"h": torch.zeros((batch, h, n, cfg.ssm_headdim), dtype=dtype,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=dtype, device=device)}


def decode_step(params, cfg, x: torch.Tensor, cache, *,
                precision: str = "bf16", impl: str = "auto",
                taps: list | None = None) -> tuple[torch.Tensor, dict]:
    """O(1) single-token step.  x (B, 1, d_model).  Returns (out, the new
    state); ``cache`` is not written."""
    bsz = x.shape[0]
    zxbcdt = C.dense(x, params["in_proj"], precision, impl, taps, "in_proj")
    z, xbc, dt, d_inner, h, g, n = _split_proj(cfg, zxbcdt)
    p = cfg.ssm_headdim

    # conv with the cached history
    hist = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # (B, k, C)
    out = torch.sum(hist * params["conv_w"][None], dim=1, keepdim=True)
    xbc1 = F.silu(out + params["conv_b"][None, None])
    new_conv = hist[:, 1:]

    xs, b_, c_ = torch.split(xbc1, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, h, p).float()
    b_ = b_.reshape(bsz, n).float()
    c_ = c_.reshape(bsz, n).float()
    dt = _softplus_dt(params, dt[:, 0])                        # (B,H)
    decay = torch.exp(dt * _a(params)[None])

    upd = (dt[:, :, None] * xs)[:, :, None, :] * b_[:, None, :, None]
    hstate = cache["h"].float() * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c_, hstate)
    y = y + xs * params["D"].float()[None, :, None]
    out = _gated_out(params, cfg, y.reshape(bsz, 1, d_inner), z, x.dtype,
                     precision, impl, taps)
    return out, {"h": hstate.to(cache["h"].dtype),
                 "conv": new_conv.to(cache["conv"].dtype)}


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


def paged_decode_step(params, cfg, x: torch.Tensor, cache,
                      slots: torch.Tensor, *, precision: str = "bf16",
                      active: torch.Tensor | None = None,
                      impl: str = "auto", taps: list | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """O(1) decode against the slot pool, in place.  x (B, 1, d); slots
    (B,) slot ids; rows with ``active`` False write to scratch slot 0.
    ``taps`` as in ``prefill_chunk``."""
    idx = slots.long()
    state = {"h": cache["h"][idx], "conv": cache["conv"][idx]}
    y, new = decode_step(params, cfg, x, state, precision=precision,
                         impl=impl, taps=taps)
    dst = slots if active is None else torch.where(active, slots, 0)
    _write_slots(cache, dst, new)
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
    bsz, c_len, _ = x.shape
    zxbcdt = C.dense(x, params["in_proj"], precision, impl, taps, "in_proj")
    z, xbc, dt, d_inner, h, g, n = _split_proj(cfg, zxbcdt)
    p = cfg.ssm_headdim
    w = params["conv_w"]
    k = w.shape[0]
    idx = slots.long()

    # depthwise causal conv over the slot's carried (k-1)-token tail
    hist = cache["conv"][idx].to(xbc.dtype)                    # (B, k-1, ch)
    full = torch.cat([hist, xbc], dim=1)                       # (B, k-1+C, ch)
    out = sum(full[:, i:i + c_len] * w[i][None, None] for i in range(k))
    xbc1 = F.silu(out + params["conv_b"][None, None])
    # the new tail: the last k-1 inputs up to the row's valid length (for
    # n_valid < k-1 part of the old tail)
    tail = n_valid.long()[:, None] + torch.arange(k - 1, device=x.device)
    new_conv = torch.gather(
        full, 1, tail[:, :, None].expand(bsz, k - 1, full.shape[-1]))

    xs, b_, c_ = torch.split(xbc1, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, c_len, h, p).float()
    b_ = b_.reshape(bsz, c_len, n).float()                     # g = 1
    c_ = c_.reshape(bsz, c_len, n).float()

    valid = torch.arange(c_len, device=x.device)[None, :] < n_valid[:, None]
    dt = _softplus_dt(params, dt) * valid[..., None]           # (B,C,H)
    cum = torch.cumsum(dt * _a(params)[None, None, :], dim=1)  # (B,C,H)
    total = cum[:, -1]                                         # (B,H)

    # intra-chunk quadratic (attention-dual) form
    cb = torch.einsum("bln,bsn->bls", c_, b_)
    seg = cum[:, :, None, :] - cum[:, None, :, :]              # (B,C,C,H)
    causal = torch.ones((c_len, c_len), dtype=torch.bool,
                        device=x.device).tril()
    seg = torch.where(causal[None, :, :, None], seg, MASKED)
    m = cb[..., None] * torch.exp(seg)
    y = torch.einsum("blsh,bshp->blhp", m, xs * dt[..., None])

    # the carried state's contribution and the new boundary state
    h0 = cache["h"][idx].float()                               # (B,H,N,P)
    y = y + torch.einsum("bln,bhnp->blhp", c_, h0) * torch.exp(cum)[..., None]
    w_s = torch.exp(total[:, None, :] - cum) * dt              # (B,C,H)
    hstate = h0 * torch.exp(total)[:, :, None, None] + _states(w_s, b_, xs)

    y = y + xs * params["D"].float()[None, None, :, None]
    out = _gated_out(params, cfg, y.reshape(bsz, c_len, d_inner), z,
                     x.dtype, precision, impl, taps)
    _write_slots(cache, torch.where(n_valid > 0, slots, 0),
                 {"h": hstate, "conv": new_conv})
    return out, cache
