"""Fused binarize -> bitpack -> XNOR-popcount GEMM:
(M, S) float x  x  (N, ceil(S/32)) packed weights  ->  (M, N).

The activation side is binarized (``x >= threshold``) and packed by
the kernel itself; only the weight arrives pre-packed (kernels/ops.py
packs each weight once).
Modes as ``ref.epilogue``: bitcount, dot, dot_scaled, binary_act.

``fused_bnn_matmul`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel (csrc/fused_bnn.cu) or raises; on a CPU tensor it
computes ``fused_bnn_matmul_torch``, the plain version.

The wrapper hands the kernel an (M, ceil(Kw/4)*4) int32 scratch for
the packed activations: the kernel packs them once, in a first launch,
except where its decode grid is a single wave and its blocks pack them
themselves.  Under ``torch.profiler`` each launch is a
``fused_bnn M=.. N=.. S=..`` range, so a trace can sum device time by
shape (``chip_profile.py``).
"""
from __future__ import annotations

import torch
import torch.autograd.profiler as _profiler

from repro_torch.core import packing
from repro_torch.kernels import _lib, ref

KERNEL = _lib.KernelInfo(
    "fused_bnn", "src/repro_torch/csrc/fused_bnn.cu",
    "src/repro/kernels/fused_bnn.py:99")

_OUT_DTYPE = {"bitcount": torch.int32, "dot": torch.int32,
              "dot_scaled": torch.float32, "binary_act": torch.uint8}


def fused_bnn_matmul_torch(x: torch.Tensor, wp: torch.Tensor, s: int, *,
                           mode: str = "dot",
                           alpha: torch.Tensor | None = None,
                           threshold: float = 0.0) -> torch.Tensor:
    """Plain version.  x's pad positions pack to 0 bits (the Pallas
    wrapper pads with ``threshold - 1``), the same as the weight's pad
    bits, so the kw-based pad correction holds."""
    if alpha is None:
        alpha = torch.ones(wp.shape[0], dtype=torch.float32, device=wp.device)
    return ref.xnor_popcount_matmul_ref(ref.binarize_pack_ref(x, threshold),
                                        wp, s, mode, alpha)


def fused_bnn_matmul(x: torch.Tensor, wp: torch.Tensor, s: int, *,
                     mode: str = "dot",
                     alpha: torch.Tensor | None = None,
                     threshold: float = 0.0) -> torch.Tensor:
    """binarize(x) @ unpack(wp).T in one kernel; ``s`` is the true
    contraction length in bits (= x.shape[1])."""
    if x.device.type == "cpu":
        return fused_bnn_matmul_torch(x, wp, s, mode=mode, alpha=alpha,
                                      threshold=threshold)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bnn_matmul: no kernel for device {x.device}")
    if mode not in _OUT_DTYPE:
        raise ValueError(f"unknown mode {mode!r}")
    if x.ndim != 2 or x.shape[1] != s:
        raise ValueError(f"fused_bnn_matmul: x {tuple(x.shape)} is not (M, {s})")
    m = x.shape[0]
    n, kw = wp.shape
    if kw != packing.packed_len(s):
        raise ValueError(f"fused_bnn_matmul: {kw} words cannot hold s={s}")
    if alpha is None:
        alpha = torch.ones(n, dtype=torch.float32, device=x.device)
    _lib.check(x, "x", torch.float32, (m, s), x.device)
    _lib.check(wp, "wp", torch.int32, (n, kw), x.device)
    _lib.check(alpha, "alpha", torch.float32, (n,), x.device)
    out = torch.empty((m, n), dtype=_OUT_DTYPE[mode], device=x.device)
    scratch = torch.empty((m, -(-kw // 4) * 4), dtype=torch.int32,
                          device=x.device)
    args = (_lib.ptr(x), _lib.ptr(wp), _lib.ptr(alpha), _lib.ptr(out),
            _lib.ptr(scratch), m, n, s, kw, float(threshold),
            ref.MODES.index(mode))
    if _profiler._is_profiler_enabled:        # tracing: name the shape
        with torch.profiler.record_function(f"fused_bnn M={m} N={n} S={s}"):
            _lib.launch("fb_fused_bnn", x.device, *args)
    else:
        _lib.launch("fb_fused_bnn", x.device, *args)
    KERNEL.launches += 1
    return out
