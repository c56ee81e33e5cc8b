"""Packed XNOR-popcount GEMM: (M, Kw) packed inputs x (N, Kw) packed
weights -> (M, N), the paper's Eq. (2) over 32-bit words.

Both operands arrive packed (``binarize_pack``, -1.0 padding, so pad
bits are 0 in both); ``s`` is the true contraction length in bits and
the pad correction is ``Kw*32 - s`` for the word count Kw passed.
Modes as ``ref.epilogue``: bitcount, dot, dot_scaled, binary_act.
``core/conv.bnn_conv2d`` runs every binarized conv layer through it.

``xnor_popcount_matmul`` is the wrapper: on a CUDA tensor it launches
the hand-written kernel (csrc/xnor_popcount.cu) or raises; on a CPU
tensor it computes ``xnor_popcount_matmul_torch``, the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.kernels import _lib, ref

KERNEL = _lib.KernelInfo(
    "xnor_popcount", "src/repro_torch/csrc/xnor_popcount.cu",
    "src/repro/kernels/xnor_popcount.py:97")

_OUT_DTYPE = {"bitcount": torch.int32, "dot": torch.int32,
              "dot_scaled": torch.float32, "binary_act": torch.uint8}


def xnor_popcount_matmul_torch(ip: torch.Tensor, wp: torch.Tensor, s: int,
                               *, mode: str = "dot",
                               alpha: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Plain version (``alpha`` defaults to ones, as in the Pallas
    wrapper)."""
    if alpha is None:
        alpha = torch.ones(wp.shape[0], dtype=torch.float32, device=wp.device)
    return ref.xnor_popcount_matmul_ref(ip, wp, s, mode, alpha)


def xnor_popcount_matmul(ip: torch.Tensor, wp: torch.Tensor, s: int, *,
                         mode: str = "dot",
                         alpha: torch.Tensor | None = None) -> torch.Tensor:
    """unpack(ip) . unpack(wp).T over ``s`` bits, in the mode's output
    type."""
    if ip.device.type == "cpu":
        return xnor_popcount_matmul_torch(ip, wp, s, mode=mode, alpha=alpha)
    if ip.device.type != "cuda":
        raise ValueError(f"xnor_popcount_matmul: no kernel for device "
                         f"{ip.device}")
    if mode not in _OUT_DTYPE:
        raise ValueError(f"unknown mode {mode!r}")
    if ip.ndim != 2 or wp.ndim != 2 or ip.shape[1] != wp.shape[1]:
        raise ValueError(f"xnor_popcount_matmul: ip {tuple(ip.shape)} and "
                         f"wp {tuple(wp.shape)} are not (M, Kw), (N, Kw)")
    m, kw = ip.shape
    n = wp.shape[0]
    if not 0 < s <= kw * packing.WORD_BITS:
        raise ValueError(f"xnor_popcount_matmul: {kw} words cannot hold s={s}")
    _lib.check(ip, "ip", torch.int32, (m, kw), ip.device)
    _lib.check(wp, "wp", torch.int32, (n, kw), ip.device)
    alpha_ptr = None            # the kernel reads alpha only in dot_scaled
    if mode == "dot_scaled":
        if alpha is None:
            alpha = torch.ones(n, dtype=torch.float32, device=ip.device)
        _lib.check(alpha, "alpha", torch.float32, (n,), ip.device)
        alpha_ptr = _lib.ptr(alpha)
    out = torch.empty((m, n), dtype=_OUT_DTYPE[mode], device=ip.device)
    _lib.launch("xp_xnor_popcount", _lib.ptr(ip), _lib.ptr(wp), alpha_ptr,
                _lib.ptr(out), m, n, s, kw, ref.MODES.index(mode))
    KERNEL.launches += 1
    return out
