"""The kernels' entry points for the model layers, with impl dispatch.

``bnn_dense`` is what the layers call for every projection:
  * precision="bf16": ordinary float matmul (the non-binarized baseline;
    float32 here, as in the JAX package's float32 models)
  * precision="bnn": the packed XNOR-popcount inference path — the
    fused binarize->pack->XNOR-popcount GEMM against the weight's
    cached packed form.

``expert_dense`` is the same projection for one expert of a MoE
layer's (E, K, N) weight stack, packed once per stack.

``paged_attention`` is what the attention block calls over the paged
KV pools (GQA, paged or sliding-window ring); ``paged_attention_mla``
what the MLA block calls over its paged latent pools.
``pack_patches``, ``pack_conv_weight`` and ``xnor_matmul`` are the
steps of the unfused packed GEMM that ``core/conv.bnn_conv2d`` runs:
the patches binarized and packed straight from the NHWC input, the
weight's cached packed words, then the packed x packed XNOR-popcount
GEMM; ``xnor_matmul_torch`` is the latter's plain version (the JAX
package's ``xnor_matmul_xla``).  ``pack_activations`` packs an (M, S)
matrix.

Dispatch (``resolve_impl``) follows the tensor's device:
  impl="auto"   a CUDA tensor launches the Hopper kernel (or raises);
                a CPU tensor takes the plain PyTorch version
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
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.core import packing
from repro_torch.kernels import binarize_pack as _bp
from repro_torch.kernels import fused_bnn as _fb
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import xnor_popcount as _xp

IMPLS = ("auto", "cuda", "torch")

KERNELS = (_fb.KERNEL, _pa.KERNEL, _bp.KERNEL, _xp.KERNEL, _pa.KERNEL_RING,
           _pa.KERNEL_MLA, _bp.KERNEL_PATCHES)


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
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return "torch"


def reset_launches():
    for k in KERNELS:
        k.launches = 0


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


def packed_weight_cache_info() -> dict:
    return {"entries": len(_weight_pack_cache)}


def cached_per_weight(w: torch.Tensor, key: tuple, make):
    """``make(w.detach())``, cached per (identity of ``w``, ``key``) and
    recomputed when ``w._version`` moves (an in-place write)."""
    full = (id(w), *key)
    hit = _weight_pack_cache.get(full)
    if hit is not None and hit[0] == w._version:
        return hit[1]
    value = make(w.detach())
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


def _pack_stack(w: torch.Tensor, impl: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, N, Kw) packed transposes of an expert stack w (E, K, N) and
    its (E, N) alphas, cached per stack identity and version.  Packed
    one expert at a time, so the transposed float copy is one expert's
    size."""
    def pack(wd):
        e, k, n = wd.shape
        wp = torch.empty((e, n, packing.packed_len(k)), dtype=torch.int32,
                         device=wd.device)
        alpha = torch.empty((e, n), dtype=torch.float32, device=wd.device)
        for i in range(e):
            wp[i] = _pack_rows(wd[i].float().t().contiguous(), impl)
            alpha[i] = torch.mean(torch.abs(wd[i].float()), dim=0)
        return wp, alpha
    return cached_per_weight(w, ("stack", impl), pack)


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
        raise NotImplementedError(
            "precision='bnn_train' (STE training) is not ported "
            "(ROADMAP.md queue 1, item 8)")
    raise ValueError(f"unknown precision {precision!r}")


def expert_dense(x: torch.Tensor, w: torch.Tensor, e: int, *,
                 precision: str = "bf16", impl: str = "auto"
                 ) -> torch.Tensor:
    """``x (M, K) @ w[e]`` for expert ``e`` of the stack ``w`` (E, K, N),
    at the precision of ``bnn_dense`` (bnn: the fused GEMM against the
    stack's cached packed words, ``dot_scaled`` with alpha = mean |w[e]|
    over K, as the JAX package's ``moe._expert_matmul``)."""
    if precision != "bnn":      # the float matmul, or bnn_dense's refusals
        return bnn_dense(x, w[e], precision=precision, impl=impl)
    impl = resolve_impl(impl, x)
    x2 = x.float().contiguous()
    wp, alpha = _pack_stack(w, impl)
    fn = _fb.fused_bnn_matmul if impl == "cuda" else \
        _fb.fused_bnn_matmul_torch
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
                        impl: str = "auto") -> torch.Tensor:
    """Paged MLA latent attention (kernels/paged_attention.py) with impl
    dispatch."""
    fn = _pa.paged_attention_mla if resolve_impl(impl, q) == "cuda" else \
        _pa.paged_attention_mla_torch
    return fn(q, c_kv_pool, k_rope_pool, block_table, k_up=k_up, v_up=v_up,
              nope_dim=nope_dim, kv_len=kv_len, q_offset=q_offset,
              causal=causal, window=window, ring=ring, newest=newest)
