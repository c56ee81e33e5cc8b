"""Token-choice top-k Mixture-of-Experts.

Two dispatches compute the same layer:

* the capacity table (``forward`` with ``capacity_factor > 0``, the
  full-sequence path): the JAX package's sort-free static dispatch — a
  cumulative-position scatter gives every (token, choice) its arrival
  position within its expert, slots past the capacity C are dropped in
  that order, and each expert runs on its (C, d) gathered rows, zeros
  in the empty slots;
* routed rows (``capacity_factor <= 0``, drop-free, the serving path):
  with no capacity no token is ever dropped, so each token's output is
  independent of the batch and only the routed (token, choice) rows are
  computed, grouped by expert.  The JAX package's drop-free table gives
  every expert T·k rows (E·T·k in all, most of them zeros); the result
  of the routed rows is the same.

Each expert's GEMMs go through ``kernels.ops.expert_dense`` against the
stacked (E, d_in, d_out) weights — at precision "bnn" the fused
XNOR-popcount kernel on the stack's cached packed words.  The router
runs in float32.  The k choices are combined in ascending choice order,
as the JAX package's scatter-add does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.layers import common as C
from repro_torch.layers import ffn


def init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
         kind: str = "swiglu", n_shared: int = 0,
         shared_d_ff: int | None = None, dtype=torch.float32,
         device=None) -> dict:
    kw = dict(generator=gen, dtype=dtype, device=device)
    p = {"router": {"w": torch.randn((d_model, n_experts), **kw)
                    .mul_((1.0 / d_model) ** 0.5)}}

    def expert_stack(din, dout):
        return torch.randn((n_experts, din, dout), **kw).mul_(
            (1.0 / din) ** 0.5)

    if kind in ("swiglu", "geglu"):
        p["gate"] = expert_stack(d_model, d_ff)
    p["up"] = expert_stack(d_model, d_ff)
    p["down"] = expert_stack(d_ff, d_model)
    if n_shared > 0:
        p["shared"] = ffn.init(gen, d_model, (shared_d_ff or d_ff) * n_shared,
                               kind, dtype=dtype, device=device)
    return p


def _route(x2d, router_w, top_k):
    logits = torch.matmul(x2d.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts the lower expert first on a tie, as
    # lax.top_k does
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_e = top_p[:, :top_k], top_e[:, :top_k]
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return topk_w, topk_e, _aux_loss(probs, topk_e), probs


def _aux_loss(probs, topk_e, groups: int = 1):
    """Switch-style load-balance loss, averaged over token groups."""
    e = probs.shape[-1]
    auxs = []
    for p, te in zip(probs.chunk(groups), topk_e.chunk(groups)):
        density = F.one_hot(te[:, 0], e).float().mean(dim=0)
        auxs.append(e * torch.sum(density * p.mean(dim=0)))
    return torch.stack(auxs).mean()


def route(x2d: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Returns (weights (T, k), experts (T, k), Switch-style load-balance
    aux loss)."""
    topk_w, topk_e, aux, _ = _route(x2d, router_w, top_k)
    return topk_w, topk_e, aux


def dispatch_tables(topk_e: torch.Tensor, n_experts: int, capacity: int):
    """Sort-free dispatch: (token_table (E*C,), valid (E*C,),
    slot_of (T*k,)); a dropped (token, choice) gets slot E*C."""
    tk = topk_e.numel()
    dev = topk_e.device
    flat_e = topk_e.reshape(-1).long()
    onehot = (flat_e[:, None] == torch.arange(n_experts, device=dev)[None]
              ).long()
    pos = torch.cumsum(onehot, dim=0) - onehot        # arrivals before me
    pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = pos_in_e < capacity
    slot = torch.where(keep, flat_e * capacity + pos_in_e,
                       n_experts * capacity)
    token_idx = torch.arange(tk, device=dev) // topk_e.shape[-1]
    # one extra slot swallows the dropped choices
    table = torch.zeros(n_experts * capacity + 1, dtype=torch.int32,
                        device=dev)
    valid = torch.zeros(n_experts * capacity + 1, dtype=torch.bool,
                        device=dev)
    table[slot[keep]] = token_idx[keep].to(torch.int32)
    valid[slot[keep]] = True
    return table[:-1], valid[:-1], slot


def _act(kind):
    return F.silu if kind == "swiglu" else C.gelu


def _expert_ffn(params, x, e, kind, precision, impl):
    """Expert ``e``'s FFN on rows x (n, d); returns (output, the down
    projection's input)."""
    def mm(v, name):
        return kops.expert_dense(v, params[name], e, precision=precision,
                                 impl=impl)
    if kind in ("swiglu", "geglu"):
        h = _act(kind)(mm(x, "gate")) * mm(x, "up")
    else:
        h = C.gelu(mm(x, "up"))
    return mm(h, "down"), h


def _combine(ye, topk_w):
    """ye (T, k, d) expert outputs per choice -> (T, d), the choices
    weighted and added in ascending order onto zeros."""
    y = torch.zeros_like(ye[:, 0])
    for j in range(ye.shape[1]):
        y = y + ye[:, j] * topk_w[:, j, None].to(ye.dtype)
    return y


def _forward_tables(params, x, *, top_k, kind, capacity, groups, precision,
                    impl):
    """The capacity-table dispatch within ``groups`` token groups."""
    b, t, d = x.shape
    e = params["router"]["w"].shape[-1]
    tg = b * t // groups
    ys, auxs = [], []
    for xg in x.reshape(groups, tg, d):
        topk_w, topk_e, aux = route(xg, params["router"]["w"], top_k)
        table, valid, slot = dispatch_tables(topk_e, e, capacity)
        xe = xg[table.long()].reshape(e, capacity, d)
        xe = xe * valid.reshape(e, capacity, 1).to(xe.dtype)
        ye = torch.stack([_expert_ffn(params, xe[i], i, kind, precision,
                                      impl)[0] for i in range(e)])
        gathered = ye.reshape(e * capacity, d)[slot.clamp(0, e * capacity - 1)]
        gathered = gathered * (slot < e * capacity)[:, None].to(ye.dtype)
        ys.append(_combine(gathered.reshape(tg, top_k, d), topk_w))
        auxs.append(aux)
    return torch.cat(ys), torch.stack(auxs).mean()


def _forward_routed(params, x, *, top_k, kind, precision, impl, taps,
                    groups: int = 1):
    """Drop-free dispatch over the routed rows only, grouped by expert
    (``groups`` matters to the aux loss alone: no token is dropped)."""
    b, t, d = x.shape
    x2d = x.reshape(b * t, d)
    topk_w, topk_e, _, probs = _route(x2d, params["router"]["w"], top_k)
    aux = _aux_loss(probs, topk_e, groups)
    flat_e = topk_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)   # (token, choice) by expert
    counts = torch.bincount(flat_e, minlength=probs.shape[-1]).tolist()
    rows = x2d[order // top_k]
    ye = torch.empty((flat_e.numel(), d), dtype=x.dtype, device=x.device)
    down_in = [] if taps is not None else None
    start = 0
    for ei, n in enumerate(counts):
        if n == 0:
            continue
        sel = order[start:start + n]
        ye[sel], h = _expert_ffn(params, rows[start:start + n], ei, kind,
                                 precision, impl)
        if down_in is not None:
            down_in.append((sel, h))
        start += n
    if taps is not None:
        taps.append(("moe_in", x))
        taps.append(("router_probs", probs.reshape(b, t, -1)))
        taps.append(("topk", topk_e.reshape(b, t, top_k)))
        dff = down_in[0][1].shape[-1]
        hd = torch.empty((flat_e.numel(), dff), dtype=x.dtype,
                         device=x.device)
        for sel, h in down_in:
            hd[sel] = h
        taps.append(("moe_down_in", hd.reshape(b, t, top_k, dff)))
    return _combine(ye.reshape(b * t, top_k, d), topk_w), aux


def forward(params, x: torch.Tensor, *, top_k: int, kind: str = "swiglu",
            capacity_factor: float = 1.25, precision: str = "bf16",
            min_capacity: int = 4, dispatch_groups: int = 1,
            impl: str = "auto", taps: list | None = None):
    """x (B, T, d) -> (y, aux_loss).

    ``dispatch_groups > 1`` routes and dispatches independently within
    that many token groups (0 = auto, one group on the one-card port:
    the JAX package matches its data-parallel degree).
    ``capacity_factor <= 0`` is the drop-free dispatch the serving path
    runs.  ``taps``, when a list, receives ``(name, tensor)`` of the
    layer's input, the router probabilities, the chosen experts, the
    down projections' inputs (drop-free path), then the shared experts'
    projection inputs.
    """
    b, t, d = x.shape
    n_tok = b * t
    g = dispatch_groups if dispatch_groups and \
        n_tok % dispatch_groups == 0 else 1
    if capacity_factor <= 0:
        y2d, aux = _forward_routed(params, x, top_k=top_k, kind=kind,
                                   precision=precision, impl=impl, taps=taps,
                                   groups=g)
    else:
        e = params["router"]["w"].shape[-1]
        cap = max(min_capacity, int(capacity_factor * (n_tok // g) * top_k / e))
        y2d, aux = _forward_tables(params, x, top_k=top_k, kind=kind,
                                   capacity=cap, groups=g,
                                   precision=precision, impl=impl)
    y = y2d.reshape(b, t, d)
    if "shared" in params:
        y = y + ffn.forward(params["shared"], x, kind, precision, impl, taps)
    return y.to(x.dtype), aux


def forward_dense_reference(params, x: torch.Tensor, *, top_k: int,
                            kind: str = "swiglu") -> torch.Tensor:
    """O(E*T) float reference: every expert computes every token."""
    b, t, d = x.shape
    x2d = x.reshape(b * t, d)
    topk_w, topk_e, _ = route(x2d, params["router"]["w"], top_k)
    if kind in ("swiglu", "geglu"):
        h = _act(kind)(torch.einsum("td,edf->etf", x2d, params["gate"])) * \
            torch.einsum("td,edf->etf", x2d, params["up"])
    else:
        h = C.gelu(torch.einsum("td,edf->etf", x2d, params["up"]))
    ye = torch.einsum("etf,efd->etd", h, params["down"])          # (E, T, d)
    gate = torch.zeros((b * t, ye.shape[0]), dtype=ye.dtype, device=x.device)
    gate.scatter_add_(1, topk_e, topk_w.to(ye.dtype))
    y2d = torch.einsum("te,etd->td", gate, ye)
    if "shared" in params:
        y2d = y2d + ffn.forward(params["shared"], x2d, kind, "bf16")
    return y2d.reshape(b, t, d).to(x.dtype)
