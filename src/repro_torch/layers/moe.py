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
runs in float32 (``kernels/ops.row_gemm``: one fixed order a row).
The k choices are combined in ascending choice order, as the JAX
package's scatter-add does.

Over a mesh (the params DTensors: ``dist/sharding.place_params``) the
layer is expert-parallel: the router is replicated, the stacks are cut
by whole experts over ``model`` (``("experts", "embed", "mlp")``; the
dedup drops ``mlp``), and the shared experts are column/row-parallel
as a dense FFN.  Each data rank routes its own rows, each model rank
runs the per-expert loop over its own experts only, and the (T·k, d)
slot rows (one per (token, choice)) are summed over ``model``: a slot
is non-zero on the one rank that owns its expert, so the sum is exact,
and the k choices are combined after it in ``_combine``'s order, so a
token's output is bit-equal to one rank's (summing each rank's combined
output would reorder a token's top-k sum, whose choices span ranks).
Where the experts do not divide the model axis (8 mixtral experts on a
16-way axis) the decode rules cut each expert's ``mlp`` instead: every
rank runs every routed expert on its slice of the hidden, the down
projection's integer dots are summed over ``model`` before alpha (as
``kernels/ops``' row-parallel GEMM does), and the choices combine
after that sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import spmd
from repro_torch.kernels import ops as kops
from repro_torch.layers import common as C
from repro_torch.layers import ffn


def init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
         kind: str = "swiglu", n_shared: int = 0,
         shared_d_ff: int | None = None, dtype=torch.float32,
         device=None, keep=None) -> dict:
    """``keep(name, stack)``, when given, takes each expert stack as soon
    as it is drawn and returns what to hold of it (a rank's slice,
    ``launch/mesh.init_on_ranks``: jamba's stacks are 12 GiB each)."""
    kw = dict(generator=gen, dtype=dtype, device=device)
    p = {"router": {"w": torch.randn((d_model, n_experts), **kw)
                    .mul_((1.0 / d_model) ** 0.5)}}

    def expert_stack(name, din, dout):
        w = torch.randn((n_experts, din, dout), **kw).mul_((1.0 / din) ** 0.5)
        return w if keep is None else keep(name, w)

    if kind in ("swiglu", "geglu"):
        p["gate"] = expert_stack("gate", d_model, d_ff)
    p["up"] = expert_stack("up", d_model, d_ff)
    p["down"] = expert_stack("down", d_ff, d_model)
    if n_shared > 0:
        p["shared"] = ffn.init(gen, d_model, (shared_d_ff or d_ff) * n_shared,
                               kind, dtype=dtype, device=device)
    return p


def specs(kind: str = "swiglu", n_shared: int = 0) -> dict:
    """Logical axes of ``init``'s leaves: the (E, d_in, d_out) stacks
    over ("experts", ...)."""
    s = {"router": {"w": ("embed", None)}}
    if kind in ("swiglu", "geglu"):
        s["gate"] = ("experts", "embed", "mlp")
    s["up"] = ("experts", "embed", "mlp")
    s["down"] = ("experts", "mlp", "embed")
    if n_shared > 0:
        s["shared"] = ffn.specs(kind)
    return s


def _route(x2d, router_w, top_k):
    """The router in float32 on the rank's rows (``kernels/ops.row_gemm``:
    a row's logits are one rank's whatever rows run beside it)."""
    logits = kops.row_gemm(x2d, spmd.local(router_w))
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
    # every choice is written, a dropped one into the spare slot, so the
    # write has a static shape
    table.scatter_(0, slot, token_idx.to(torch.int32))
    valid.scatter_(0, slot, keep)
    return table[:-1], valid[:-1], slot


def _act(kind):
    return F.silu if kind == "swiglu" else C.gelu


def _expert_ffn(params, x, e, kind, precision, impl):
    """Expert ``e``'s FFN on rows x (n, d) (``e`` indexes the stacks as
    given: over a mesh the rank's local ones); returns (output, the
    down projection's input).  Stacks cut on ``mlp`` give the rank's
    slice of the hidden and the down projection's partial integer dots
    (``kernels.ops.expert_dense``)."""
    def mm(v, name):
        return kops.expert_dense(v, params[name], e, precision=precision,
                                 impl=impl)
    if kind in ("swiglu", "geglu"):
        h = _act(kind)(mm(x, "gate")) * mm(x, "up")
    else:
        h = C.gelu(mm(x, "up"))
    return mm(h, "down"), h


class _Experts:
    """Which experts this rank runs and how its slot rows are finished:
    on one rank every expert, as they are; over a mesh (the stacks
    DTensors) the rank's own experts, their rows summed over ``model``
    (module docstring), or, with the stacks cut on ``mlp``, every
    expert's partial dots, summed and then scaled by alpha."""

    def __init__(self, params, precision: str):
        self.precision = precision
        w = params["down"]
        self.n = params["router"]["w"].shape[-1]
        self.mesh = w.device_mesh if spmd.is_dtensor(w) else None
        self.first, self.count, self.tp = 0, self.n, False
        self.dims: list[int] = []
        if self.mesh is None:
            return
        if spmd.mesh_dims(w, 0):
            self.dims = spmd.mesh_dims(w, 0)
            self.first, self.count = spmd.rank_slice(w, 0)
        elif spmd.mesh_dims(w, 1):
            self.dims, self.tp = spmd.mesh_dims(w, 1), True
        self.params = params

    def local(self, e: int) -> int | None:
        """Expert ``e``'s index in the rank's stacks, None when another
        rank runs it."""
        i = e - self.first
        return i if 0 <= i < self.count else None

    def whole_rows(self, h: torch.Tensor, experts: torch.Tensor
                   ) -> torch.Tensor:
        """Slot rows of the down projections' inputs (n, the rank's
        hidden; slot i of expert ``experts[i]``), every slot's whole
        hidden on every rank, as one rank has it (a debug tap: the
        owner's rows are gathered, not summed, so a -0.0 stays)."""
        if self.mesh is None:
            return h
        if self.tp:
            for i in reversed(self.dims):
                h = spmd.all_gather(h, self.mesh, i, 1)
            return h
        parts = h[None]
        for i in reversed(self.dims):
            parts = spmd.all_gather(parts, self.mesh, i, 0)
        rows = torch.arange(h.shape[0], device=h.device)
        return parts[experts.long() // self.count, rows]

    def finish(self, ye: torch.Tensor, experts: torch.Tensor, impl: str
               ) -> torch.Tensor:
        """The slot rows ``ye`` (n, d), slot i computed by expert
        ``experts[i]``, summed over the ranks that share them."""
        if self.mesh is None:
            return ye
        for i in self.dims:
            ye = spmd.all_reduce(ye, self.mesh, i)
        if self.tp and self.precision in ("bnn", "bnn_train"):
            alpha = (kops.expert_alphas(self.params["down"], impl)
                     if self.precision == "bnn" else
                     kops.train_expert_alphas(self.params["down"]))
            ye = ye.to(torch.float32) * alpha[experts.long()]
        return ye


def _combine(ye, topk_w):
    """ye (T, k, d) expert outputs per choice -> (T, d), the choices
    weighted and added in ascending order onto zeros."""
    y = torch.zeros_like(ye[:, 0])
    for j in range(ye.shape[1]):
        y = y + ye[:, j] * topk_w[:, j, None].to(ye.dtype)
    return y


def _forward_tables(params, x, *, top_k, kind, capacity, groups, precision,
                    impl):
    """The capacity-table dispatch within ``groups`` token groups (x: the
    rank's rows, a whole number of groups)."""
    b, t, d = x.shape
    ex = _Experts(params, precision)
    e = ex.n
    tg = b * t // groups
    ys, auxs, outs = [], [], []
    for xg in x.reshape(groups, tg, d):
        topk_w, topk_e, aux = route(xg, params["router"]["w"], top_k)
        table, valid, slot = dispatch_tables(topk_e, e, capacity)
        xe = xg[table.long()].reshape(e, capacity, d)
        xe = xe * valid.reshape(e, capacity, 1).to(xe.dtype)
        if ex.mesh is None:
            ye = torch.stack([_expert_ffn(params, xe[i], i, kind, precision,
                                          impl)[0] for i in range(e)])
        else:
            ye = torch.zeros((e, capacity, d), dtype=x.dtype,
                             device=x.device)
            for i in range(e):
                li = i if ex.tp else ex.local(i)
                if li is not None:
                    ye[i] = _expert_ffn(params, xe[i], li, kind, precision,
                                        impl)[0].to(ye.dtype)
        gathered = ye.reshape(e * capacity, d)[slot.clamp(0, e * capacity - 1)]
        gathered = gathered * (slot < e * capacity)[:, None].to(ye.dtype)
        outs.append((gathered, topk_e, topk_w))
        auxs.append(aux)
    if ex.mesh is not None:
        rows = ex.finish(torch.cat([g for g, _e, _w in outs]),
                         torch.cat([te.reshape(-1) for _g, te, _w in outs]),
                         impl)
        outs = [(r, te, w) for r, (_g, te, w) in
                zip(rows.split(tg * top_k), outs)]
    for gathered, _te, topk_w in outs:
        ys.append(_combine(gathered.reshape(tg, top_k, d).to(x.dtype),
                           topk_w))
    return torch.cat(ys), torch.stack(auxs).mean()


def _expert_counts(flat_e: torch.Tensor, n: int) -> list[int]:
    """The rows routed to each of the ``n`` experts; on ``meta`` (the
    dry-run: no values to route by) as even as they can be."""
    if flat_e.device.type == "meta":
        q, r = divmod(flat_e.numel(), n)
        return [q + (e < r) for e in range(n)]
    return torch.bincount(flat_e, minlength=n).tolist()


def _forward_routed(params, x, *, top_k, kind, precision, impl, taps,
                    groups: int = 1):
    """Drop-free dispatch over the routed rows only, grouped by expert
    (``groups`` matters to the aux loss alone: no token is dropped).  x:
    the rank's rows; over a mesh the rank runs its experts' rows and
    the slot rows are finished over ``model`` (``_Experts``)."""
    b, t, d = x.shape
    ex = _Experts(params, precision)
    x2d = x.reshape(b * t, d)
    topk_w, topk_e, _, probs = _route(x2d, params["router"]["w"], top_k)
    aux = _aux_loss(probs, topk_e, groups)
    flat_e = topk_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)   # (token, choice) by expert
    counts = _expert_counts(flat_e, probs.shape[-1])
    rows = x2d[order // top_k]
    make = torch.empty if ex.mesh is None else torch.zeros
    ye = make((flat_e.numel(), d), dtype=x.dtype, device=x.device)
    down_in = [] if taps is not None else None
    start = 0
    for ei, n in enumerate(counts):
        li = ei if ex.tp else ex.local(ei)
        if n == 0 or li is None:
            start += n
            continue
        sel = order[start:start + n]
        y_e, h = _expert_ffn(params, rows[start:start + n], li, kind,
                             precision, impl)
        ye[sel] = y_e.to(ye.dtype)
        if down_in is not None:
            down_in.append((sel, h))
        start += n
    ye = ex.finish(ye, flat_e, impl).to(x.dtype)
    if taps is not None:
        taps.append(("moe_in", x))
        taps.append(("router_probs", probs.reshape(b, t, -1)))
        taps.append(("topk", topk_e.reshape(b, t, top_k)))
        hd = torch.zeros((flat_e.numel(),
                          spmd.local(params["down"]).shape[1]),
                         dtype=x.dtype, device=x.device)
        for sel, h in down_in:
            hd[sel] = h
        taps.append(("moe_down_in", ex.whole_rows(hd, flat_e).reshape(
            b, t, top_k, params["down"].shape[1])))
    return _combine(ye.reshape(b * t, top_k, d), topk_w), aux


def _groups(dispatch_groups: int) -> int:
    """``dispatch_groups``, 0 (auto) resolved as the JAX package does:
    the data-parallel degree of the sharding context's mesh (the mesh
    sizes the rules give "batch"), 1 outside a context."""
    if dispatch_groups:
        return dispatch_groups
    mesh, rules = C._CTX.mesh, C._CTX.rules
    if mesh is None or rules is None:
        return 1
    mx = rules.get("batch")
    parts = mx if isinstance(mx, tuple) else (mx,) if mx else ()
    sizes = C.mesh_axes(mesh)
    dp = 1
    for p in parts:
        dp *= sizes[p]
    return dp


def forward(params, x: torch.Tensor, *, top_k: int, kind: str = "swiglu",
            capacity_factor: float = 1.25, precision: str = "bf16",
            min_capacity: int = 4, dispatch_groups: int = 1,
            impl: str = "auto", taps: list | None = None):
    """x (B, T, d) -> (y, aux_loss).

    ``dispatch_groups > 1`` routes and dispatches independently within
    that many token groups (0 = auto: the data-parallel degree of the
    sharding context's mesh, 1 outside one, as in the JAX package).
    ``capacity_factor <= 0`` is the drop-free dispatch the serving path
    runs.  ``taps``, when a list, receives ``(name, tensor)`` of the
    layer's input, the router probabilities, the chosen experts, the
    down projections' inputs (drop-free path), then the shared experts'
    projection inputs.  Over a mesh (module docstring) x is a DTensor
    with its rows over ``data``; each data rank dispatches the groups
    its rows hold (the rows are gathered first where a group spans
    ranks), and the aux loss of the drop-free path is that of the
    rank's rows (the serving path drops it).
    """
    b, t, d = x.shape
    n_tok = b * t
    g = _groups(dispatch_groups)
    g = g if n_tok % g == 0 else 1
    xin = x
    if spmd.is_dtensor(x) and g % spmd.shards(x, 0):
        x = spmd.all_rows(x)
    gl = g // spmd.shards(x, 0)
    xl = spmd.local(x)
    if capacity_factor <= 0:
        rank_taps = [] if taps is not None else None
        y2d, aux = _forward_routed(params, xl, top_k=top_k, kind=kind,
                                   precision=precision, impl=impl,
                                   taps=rank_taps, groups=gl)
        if taps is not None:      # the rank's rows, placed as x's are
            taps.extend((n, spmd.wrap_like(t, x)) for n, t in rank_taps)
    else:
        e = params["router"]["w"].shape[-1]
        cap = max(min_capacity, int(capacity_factor * (n_tok // g) * top_k / e))
        y2d, aux = _forward_tables(params, xl, top_k=top_k, kind=kind,
                                   capacity=cap, groups=gl,
                                   precision=precision, impl=impl)
        aux = _mean_over_rows(aux, x, g)
    y = spmd.wrap_like(y2d.reshape(xl.shape), x)
    if spmd.is_dtensor(y):
        y = spmd.redistribute(y, xin.placements)
    if "shared" in params:
        sh = ffn.forward(params["shared"], xin, kind, precision, impl, taps)
        y = spmd.on_local(lambda a, s: a + s, y, sh)
    return spmd.on_local(lambda a: a.to(x.dtype), y), aux


def _mean_over_rows(aux: torch.Tensor, x, groups: int) -> torch.Tensor:
    """The mean of every group's aux loss, from this rank's mean over the
    groups its rows hold (a sum over the data ranks)."""
    dims = spmd.mesh_dims(x, 0) if spmd.is_dtensor(x) else []
    if not dims:
        return aux
    total = aux * (groups // spmd.shards(x, 0))
    for i in dims:
        total = spmd.all_reduce(total.clone(), x.device_mesh, i)
    return total / groups


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
