"""The kernels' entry points for the model layers, with impl dispatch.

``bnn_dense`` is what the layers call for every projection:
  * precision="bf16": ordinary float matmul (the non-binarized baseline;
    float32 here, as in the JAX package's float32 models)
  * precision="bnn_train": the STE-binarized training GEMM
    (``core/xnor.bnn_matmul_train``: a float matmul of the signs times
    alpha, differentiable; no kernel, as in the JAX package)
  * precision="bnn": the packed XNOR-popcount inference path — the
    fused binarize->pack->XNOR-popcount GEMM against the weight's
    cached packed form.

``expert_dense`` is the same projection for one expert of a MoE
layer's (E, K, N) weight stack, packed once per stack (over a mesh,
the rank's experts or its slice of each).

``paged_attention`` is what the attention block calls over the paged
KV pools (GQA, paged or sliding-window ring); ``paged_attention_mla``
what the MLA block calls over its paged latent pools.
``row_gemm`` and ``row_norm`` are float32 ops with one fixed order of
rounding a row (kernels/rowwise.py): the LM head and the MoE router,
RMSNorm and LayerNorm, whose rows come out the same whatever rows or
columns run beside them (a data rank's rows, a model rank's vocab
slice).
``pack_patches``, ``pack_conv_weight`` and ``xnor_matmul`` are the
steps of the unfused packed GEMM that ``core/conv.bnn_conv2d`` runs:
the patches binarized and packed straight from the NHWC input, the
weight's cached packed words, then the packed x packed XNOR-popcount
GEMM; ``xnor_matmul_torch`` is the latter's plain version (the JAX
package's ``xnor_matmul_xla``).  ``pack_activations`` packs an (M, S)
matrix.

Dispatch (``resolve_impl``) follows the tensor's device:
  impl="auto"   a CUDA tensor launches the Hopper kernel (or raises);
                a CPU tensor takes the plain PyTorch version, and so
                does a ``meta`` one (the dry-run's shapes, no values)
  impl="cuda"   the Hopper kernel; raises on a CPU tensor
  impl="torch"  the plain version anywhere — an explicit request, made
                only by the tests and chip_smoke.py to check a kernel
Nothing falls back: a kernel that fails to build or launch raises.

Weights are packed once: ``binarize_pack(w.T)`` and
``alpha = mean(|w|, axis=0)`` are cached per (weight identity, impl,
scale) and recomputed only when the weight's ``_version`` moves (it was
written in place); ``cached_per_weight`` keeps every such per-weight
value (a conv weight's packed words and its SAME border term too).  An
entry is evicted with its weight (weakref).  An
expert stack (E, K, N) is packed as a whole, into (E, N, Kw) words and
(E, N) alphas, under the stack's identity: a per-expert view ``w[e]``
is a new tensor at every call, so keying on it would repack every
expert at every step.

On a weight that is a DTensor (the forward over several ranks,
``dist/sharding.place_params``) ``bnn_dense`` runs each rank's kernel
on its shard, and never gathers a weight in front of a kernel:
  * column-parallel (w sharded on N: q, k, v, gate, up, the LM head):
    the rank's N columns of the output;
  * row-parallel (w sharded on K: o, down): the rank's partial product
    over its K slice (at "bnn" the integer ``dot``, its pad bits
    corrected for the slice's own word count), summed over the ranks,
    and only then scaled by alpha, so the result is bit-equal to one
    rank's ``dot_scaled``.
The shard's packed words and its alpha are cached under the DTensor
weight (a stable object: a ``to_local()`` view is new at every call).
Alpha is ``mean |w|`` over the whole K, taken, as on one rank, by
``torch.mean`` over the whole weight, which is gathered for that once,
at pack time: a sum of the ranks' partial sums rounds differently
(about 37 % of the columns of a 768 x 768 weight at tp = 2 differ in
the last bit), and the integer path is held bit-equal to one rank.

Training over a mesh ("bnn_train", "bf16") runs the same placements on
a weight gathered over ``data`` at its use (FSDP,
``transformer._layer``), never cached: the STE GEMM of the rank's
shard; where K is cut the products of the signs (integers in float32,
exact in any order) are summed over the ranks, then scaled by an alpha
whose sum of |w| over the whole K is summed over the ranks too (within
float rounding of one rank's, and differentiable: the collectives carry
the gradient, ``dist/spmd``).
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.core import packing, xnor
from repro_torch.core.binarize import ste_sign
from repro_torch.dist import spmd
from repro_torch.kernels import binarize_pack as _bp
from repro_torch.kernels import fused_bnn as _fb
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rowwise as _rw
from repro_torch.kernels import xnor_popcount as _xp

IMPLS = ("auto", "cuda", "torch")

KERNELS = (_fb.KERNEL, _pa.KERNEL, _bp.KERNEL, _xp.KERNEL, _pa.KERNEL_RING,
           _pa.KERNEL_MLA, _bp.KERNEL_PATCHES, _rw.KERNEL_GEMM,
           _rw.KERNEL_NORM)


def resolve_impl(impl: str, t: torch.Tensor) -> str:
    """'cuda' or 'torch' for an operation on tensor ``t`` (see module
    docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want one of {IMPLS})")
    if impl == "torch":
        return "torch"
    if t.device.type == "cuda":
        return "cuda"
    if impl == "cuda":
        raise ValueError(f"impl='cuda' asked for a tensor on {t.device}")
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return "torch"


def reset_launches():
    for k in KERNELS:
        k.launches = 0


# --------------------------------------------------------------------------
# the fixed-order row-wise float ops (kernels/rowwise.py)


def row_gemm(x: torch.Tensor, w: torch.Tensor, *,
             impl: str = "auto") -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N) float32, each output summed in
    K-chunks of 256, the chunks in order (kernels/rowwise.py), with impl
    dispatch."""
    return _rw.row_gemm(x, w, resolve_impl(impl, x) == "cuda")


def row_norm(x: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor | None = None, *, eps: float = 1e-6,
             kind: str = "rmsnorm", impl: str = "auto") -> torch.Tensor:
    """RMSNorm or LayerNorm (``kind``) of x over its last dim, float32,
    one fixed order a row (kernels/rowwise.py), with impl dispatch."""
    if kind not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm {kind!r}")
    return _rw.row_norm(x, scale, bias, eps, kind == "layernorm",
                        resolve_impl(impl, x) == "cuda")


# --------------------------------------------------------------------------
# the unfused packed path: binarize-pack, then XNOR-popcount GEMM

xnor_matmul_torch = _xp.xnor_popcount_matmul_torch


def xnor_matmul(ip: torch.Tensor, wp: torch.Tensor, s: int, *,
                mode: str = "dot", alpha: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
    """Packed XNOR-popcount GEMM (kernels/xnor_popcount.py) with impl
    dispatch."""
    fn = _xp.xnor_popcount_matmul if resolve_impl(impl, ip) == "cuda" else \
        xnor_matmul_torch
    return fn(ip, wp, s, mode=mode, alpha=alpha)


def pack_activations(x: torch.Tensor, *, threshold: float = 0.0,
                     impl: str = "auto") -> torch.Tensor:
    """Binarize + bitpack (kernels/binarize_pack.py) with impl
    dispatch: (M, S) float32 -> (M, ceil(S/32)) int32 words."""
    if resolve_impl(impl, x) == "cuda":
        return _bp.binarize_pack(x, threshold=threshold)
    return _bp.binarize_pack_torch(x, threshold)


def pack_patches(x: torch.Tensor, kh: int, kw: int, stride: int,
                 padding: str, *, threshold: float = 0.0,
                 impl: str = "auto") -> torch.Tensor:
    """Binarize + bitpack of a conv's patch rows, read from the NHWC
    input (kernels/binarize_pack.py) with impl dispatch:
    (B, H, W, C) float32 -> (B*H'*W', ceil(kh*kw*C/32)) int32 words."""
    fn = _bp.pack_patches if resolve_impl(impl, x) == "cuda" else \
        _bp.pack_patches_torch
    return fn(x, kh, kw, stride, padding, threshold=threshold)


# --------------------------------------------------------------------------
# packed-weight cache: one pack per weight identity and version

_weight_pack_cache: dict[tuple, tuple[int, object]] = {}
_packs = {"packs": 0}            # values made (misses), since import


def packed_weight_cache_info() -> dict:
    return {"entries": len(_weight_pack_cache), "packs": _packs["packs"]}


def cached_bytes(kinds: tuple[str, ...], weights=None) -> int:
    """The bytes of the cached values whose key starts with one of
    ``kinds`` (``cached_per_weight``'s ``key[0]``), of the tensors
    ``weights`` only where given."""
    ids = None if weights is None else {id(w) for w in weights}
    total = 0
    for full, (_v, value) in list(_weight_pack_cache.items()):
        if full[1] in kinds and (ids is None or full[0] in ids):
            for t in (value if isinstance(value, tuple) else (value,)):
                if t is not None:
                    total += t.numel() * t.element_size()
    return total


def cached_per_weight(w: torch.Tensor, key: tuple, make):
    """``make(w.detach())``, cached per (identity of ``w``, ``key``) and
    recomputed when ``w._version`` moves (an in-place write; the
    optimizer bumps a DTensor's, whose shard it writes).  Where autograd
    wants ``w``'s gradient (a train step's graph) ``make(w)`` itself,
    made anew at each use and never cached: a cached value is cut off
    from the graph (the Mamba-2 pieces gathered whole, MLA's up
    projections over a mesh)."""
    if torch.is_grad_enabled() and w.requires_grad:
        return make(w)
    full = (id(w), *key)
    hit = _weight_pack_cache.get(full)
    if hit is not None and hit[0] == w._version:
        return hit[1]
    with spmd.tagged(first_use=True):     # the dry-run keeps it apart
        value = make(w.detach())
    _packs["packs"] += 1
    if hit is None:
        # id() values recycle after gc — evict the entry with its owner
        weakref.finalize(w, _weight_pack_cache.pop, full, None)
    _weight_pack_cache[full] = (w._version, value)
    return value


def _pack_rows(wt: torch.Tensor, impl: str) -> torch.Tensor:
    return (_bp.binarize_pack(wt) if impl == "cuda"
            else _bp.binarize_pack_torch(wt))


def _pack_weight(w: torch.Tensor, impl: str, scale: bool
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(N, Kw) packed transpose of w (K, N) plus its LQ-Nets alpha
    column scales, cached per weight identity and version."""
    def pack(wd):
        wp = _pack_rows(wd.float().t().contiguous(), impl)
        return wp, (torch.mean(torch.abs(wd.float()), dim=0) if scale
                    else None)
    return cached_per_weight(w, ("dense", impl, scale), pack)


def _expert_alpha(w, i: int) -> torch.Tensor:
    """Alpha (mean |w| over K) of the rank's expert ``i`` of the stack
    ``w``, for the rank's output columns: from the local expert where
    the rank holds it whole, else from the expert gathered whole over
    the mesh dims that cut it (as ``_pack_shard`` takes a dense
    weight's)."""
    wi = spmd.local(w)[i]
    if not spmd.is_dtensor(w):
        return torch.mean(torch.abs(wi.float()), dim=0)
    for d in (1, 2):
        for m in reversed(spmd.mesh_dims(w, d)):
            wi = spmd.all_gather(wi, w.device_mesh, m, d - 1)
    alpha = torch.mean(torch.abs(wi.float()), dim=0)
    start, n = spmd.rank_slice(w, 2)
    return alpha[start:start + n]


def _pack_stack(w: torch.Tensor, impl: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, N, Kw) packed transposes of an expert stack w (E, K, N) and
    its (E, N) alphas, cached per stack identity and version.  Packed
    one expert at a time, so the transposed float copy is one expert's
    size.  Of a DTensor stack, the rank's shard (its experts, or its
    slice of each) and the alphas of its output columns."""
    def pack(wd):
        wl = spmd.local(wd)
        e, k, n = wl.shape
        wp = torch.empty((e, n, packing.packed_len(k)), dtype=torch.int32,
                         device=wl.device)
        alpha = torch.empty((e, n), dtype=torch.float32, device=wl.device)
        for i in range(e):
            wp[i] = _pack_rows(wl[i].float().t().contiguous(), impl)
            alpha[i] = _expert_alpha(wd, i)
        return wp, alpha
    return cached_per_weight(w, ("stack", impl), pack)


def expert_alphas(w, impl: str = "auto") -> torch.Tensor:
    """The (E, N) alphas of the expert stack ``w`` (a DTensor cut on K:
    of the whole K) that ``expert_dense``'s partial dots are scaled by
    once summed."""
    return _pack_stack(w, resolve_impl(impl, spmd.local(w)))[1]


def train_expert_alphas(w) -> torch.Tensor:
    """The (E, N) alphas of a DTensor expert stack cut on K, at
    "bnn_train": mean |w| over the whole K of each of the rank's
    experts' columns, differentiable (``_train_alpha``)."""
    dims = spmd.mesh_dims(w, 1)
    return _train_alpha(spmd.local(w), w.device_mesh, dims, w.shape[1],
                        dim=1)[:, 0]


def pack_conv_weight(w: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """(C_out, Kw) packed words of an HWIO conv weight flattened as its
    patches are, ``w.reshape(S, C_out)``, cached per weight identity and
    version (the JAX conv packs it at every call; the words are the
    same)."""
    impl = resolve_impl(impl, w)
    kh, kw, cin, cout = w.shape
    return cached_per_weight(w, ("conv", impl), lambda wt: _pack_rows(
        wt.float().reshape(kh * kw * cin, cout).t().contiguous(), impl))


def bnn_dense(x: torch.Tensor, w: torch.Tensor, *, precision: str = "bf16",
              impl: str = "auto", scale: bool = True) -> torch.Tensor:
    """Dense projection with selectable precision path.

    x: (..., K) activations; w: (K, N) latent weights (float).
    """
    if spmd.is_dtensor(w):
        return _tp_dense(x, w, precision, impl, scale)
    if precision == "bf16":
        return torch.matmul(x, w.to(x.dtype))
    if precision == "bnn":
        impl = resolve_impl(impl, x)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).float().contiguous()
        s = x2.shape[-1]
        mode = "dot_scaled" if scale else "dot"
        wp, alpha = _pack_weight(w, impl, scale)
        fn = _fb.fused_bnn_matmul if impl == "cuda" else \
            _fb.fused_bnn_matmul_torch
        y = fn(x2, wp, s, mode=mode, alpha=alpha)
        return y.reshape(*lead, w.shape[-1]).to(x.dtype)
    if precision == "bnn_train":
        lead = x.shape[:-1]
        y = xnor.bnn_matmul_train(x.reshape(-1, x.shape[-1]), w, scale=scale)
        return y.reshape(*lead, w.shape[-1])
    raise ValueError(f"unknown precision {precision!r}")


def _pack_shard(w, impl: str, scale: bool):
    """The packed words of this rank's shard of the DTensor weight ``w``
    and the alpha of its output columns (module docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    def pack(wd):
        wp = _pack_rows(spmd.local(wd).float().t().contiguous(), impl)
        if not scale:
            return wp, None
        alpha = torch.mean(torch.abs(spmd.full(wd).float()), dim=0)
        cols = [Shard(0) if p == Shard(1) else Replicate()
                for p in wd.placements]
        return wp, spmd.place(alpha, wd.device_mesh, cols).to_local()
    return cached_per_weight(w, ("shard", impl, scale), pack)


def _tp_dense(x, w, precision: str, impl: str, scale: bool):
    """``bnn_dense`` with a DTensor weight (module docstring).  Per mesh
    dim: where w is cut on K, x must be cut on its last dim and the
    partial products are summed; elsewhere x's last dim is held whole
    and its other placements (the data-parallel rows) carry over."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = w.device_mesh
    if not spmd.is_dtensor(x):
        x = spmd.replicate(x, mesh)
    last = x.ndim - 1
    want, out, summed = [], [], []
    for i, (pw, px) in enumerate(zip(w.placements, x.placements)):
        keep = Replicate() if px == Shard(last) else px
        if pw == Shard(0):
            want.append(Shard(last))
            out.append(Replicate())
            summed.append(i)
        else:
            want.append(keep)
            out.append(Shard(last) if pw == Shard(1) else keep)
    x = spmd.redistribute(x, want)
    xl, wl = x.to_local(), w.to_local()
    if precision == "bf16":
        y = torch.matmul(xl, wl.to(xl.dtype))
        for i in summed:
            y = spmd.all_reduce(y, mesh, i)
    elif precision == "bnn":
        impl = resolve_impl(impl, xl)
        x2 = xl.reshape(-1, xl.shape[-1]).float().contiguous()
        wp, alpha = _pack_shard(w, impl, scale)
        fn = _fb.fused_bnn_matmul if impl == "cuda" else \
            _fb.fused_bnn_matmul_torch
        if summed:
            y = fn(x2, wp, x2.shape[-1], mode="dot")
            for i in summed:
                y = spmd.all_reduce(y, mesh, i)
            y = y.to(torch.float32) * alpha[None, :] if scale else y
        else:
            y = fn(x2, wp, x2.shape[-1],
                   mode="dot_scaled" if scale else "dot", alpha=alpha)
        y = y.reshape(*xl.shape[:-1], wl.shape[-1]).to(xl.dtype)
    elif precision == "bnn_train":
        y = _ste_partial(xl.reshape(-1, xl.shape[-1]), wl, mesh, summed,
                         w.shape[0], scale)
        y = y.reshape(*xl.shape[:-1], wl.shape[-1]).to(xl.dtype)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return spmd.wrap(y, mesh, out, (*x.shape[:-1], w.shape[-1]))


def _ste_partial(x2, wl, mesh, summed, k: int, scale: bool):
    """``xnor.bnn_matmul_train`` on a rank's shard ``wl`` (K slice, N
    columns) of a weight whose K is cut over the mesh dims ``summed``:
    the products of the signs are summed over them (integers in float32,
    exact in any order), then scaled by alpha = mean |w| over the whole
    K (``_train_alpha``).  Where K is whole (a column-parallel or
    replicated weight) exactly one rank's: a column's mean over K has
    the same bits beside any other columns (``chip_ranks_full.py
    --train``)."""
    if not summed:
        return xnor.bnn_matmul_train(x2, wl, scale=scale).float()
    y = torch.matmul(ste_sign(x2).float(), ste_sign(wl).float())
    for i in summed:
        y = spmd.all_reduce(y, mesh, i)
    if scale:
        y = y * _train_alpha(wl, mesh, summed, k)
    return y


def _train_alpha(wl, mesh, summed, k: int, dim: int = 0):
    """alpha = mean |w| over a K cut over ``summed`` (``wl``'s shard,
    K along ``dim``), keeping the dim, with JAX's |w| derivative
    (``xnor.abs_jax``).  Its value is one rank's: ``torch.mean`` over
    the whole K, the shard gathered over ``summed`` without a gradient
    (the sum of the ranks' partial sums rounds differently, and a
    later projection's input would then flip a sign near zero: the STE
    step is not a rounding away from one rank's any more).  Its
    gradient is that of the ranks' partial sums, summed (the same
    function: ``exact + (a - a.detach())`` adds exactly 0.0)."""
    with torch.no_grad():
        whole = wl.detach()
        for i in reversed(summed):
            whole = spmd.all_gather(whole, mesh, i, dim)
        exact = torch.mean(xnor.abs_jax(whole.float()), dim=dim,
                           keepdim=True)
    a = torch.sum(xnor.abs_jax(wl.float()), dim=dim, keepdim=True)
    for i in summed:
        a = spmd.all_reduce(a, mesh, i)
    a = a / k
    return exact + (a - a.detach())


def expert_dense(x: torch.Tensor, w: torch.Tensor, e: int, *,
                 precision: str = "bf16", impl: str = "auto"
                 ) -> torch.Tensor:
    """``x (M, K) @ w[e]`` for expert ``e`` of the stack ``w`` (E, K, N),
    at the precision of ``bnn_dense`` (bnn: the fused GEMM against the
    stack's cached packed words, ``dot_scaled`` with alpha = mean |w[e]|
    over K, as the JAX package's ``moe._expert_matmul``; bnn_train: the
    STE GEMM with that alpha, differentiable).

    Of a DTensor stack (the MoE layer over a mesh), ``e`` indexes the
    rank's shard: a stack cut by experts holds whole experts (the
    result is one rank's); one cut on N gives the rank's output columns
    (alpha from the whole expert); one cut on K (``x`` the rank's K
    slice) gives the rank's partial product, at "bnn" the integer
    ``dot`` with the slice's own pad correction, which the caller sums
    over the ranks and scales by ``expert_alphas``."""
    k_cut = spmd.is_dtensor(w) and bool(spmd.mesh_dims(w, 1))
    if precision == "bnn_train" and k_cut:
        # the partial STE product; ``moe._Experts.finish`` sums it over
        # the ranks and scales it by ``train_expert_alphas``
        return torch.matmul(ste_sign(x).float(),
                            ste_sign(spmd.local(w)[e]).float()).to(x.dtype)
    if precision != "bnn":      # the float matmul, the STE GEMM
        return bnn_dense(x, spmd.local(w)[e], precision=precision, impl=impl)
    impl = resolve_impl(impl, x)
    x2 = x.float().contiguous()
    wp, alpha = _pack_stack(w, impl)
    fn = _fb.fused_bnn_matmul if impl == "cuda" else \
        _fb.fused_bnn_matmul_torch
    if k_cut:
        return fn(x2, wp[e], x2.shape[-1], mode="dot")
    return fn(x2, wp[e], x2.shape[-1], mode="dot_scaled",
              alpha=alpha[e]).to(x.dtype)


def paged_attention(q, k_pool, v_pool, block_table, *, kv_len, q_offset,
                    causal: bool = False, window: int | None = None,
                    ring: bool = False, newest=None,
                    impl: str = "auto") -> torch.Tensor:
    """Paged GQA attention, paged or ring (kernels/paged_attention.py),
    with impl dispatch."""
    fn = _pa.paged_attention if resolve_impl(impl, q) == "cuda" else \
        _pa.paged_attention_torch
    return fn(q, k_pool, v_pool, block_table, kv_len=kv_len,
              q_offset=q_offset, causal=causal, window=window, ring=ring,
              newest=newest)


def paged_attention_mla(q, c_kv_pool, k_rope_pool, block_table, *, k_up,
                        v_up, nope_dim: int, kv_len, q_offset,
                        causal: bool = False, window: int | None = None,
                        ring: bool = False, newest=None,
                        route_heads: int | None = None,
                        impl: str = "auto") -> torch.Tensor:
    """Paged MLA latent attention (kernels/paged_attention.py) with impl
    dispatch; ``route_heads`` as the kernel's (the plain version has
    one route)."""
    kw = dict(k_up=k_up, v_up=v_up, nope_dim=nope_dim, kv_len=kv_len,
              q_offset=q_offset, causal=causal, window=window, ring=ring,
              newest=newest)
    if resolve_impl(impl, q) == "cuda":
        return _pa.paged_attention_mla(q, c_kv_pool, k_rope_pool,
                                       block_table, route_heads=route_heads,
                                       **kw)
    return _pa.paged_attention_mla_torch(q, c_kv_pool, k_rope_pool,
                                         block_table, **kw)
