"""Binary quantizers for OXBNN (paper Eq. 1) with a straight-through
estimator.

The paper binarizes with ``Q(x) = sign(x) = x >= 0 ? +1 : -1`` and uses
the equivalent {0,1} encoding in its hardware (Section II-A).  Both
encodings are here, with the LQ-Nets-style scale (weights binarized as
``alpha * sign(w)``).

``torch.sign(0)`` is 0, not +1: nothing here uses it.  Every sign of
the packed path goes through ``sign_pm1``, so padded zeros binarize to
+1 exactly as the packed bits (``x >= 0``) do.
"""
from __future__ import annotations

import torch


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (1): x >= 0 ? +1 : -1 (sign(0) = +1, unlike torch.sign)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def binarize_01(x: torch.Tensor) -> torch.Tensor:
    """{0,1} encoding used by the XPC hardware (Section II-A)."""
    return (x >= 0).to(torch.uint8)


def pm1_to_01(b: torch.Tensor) -> torch.Tensor:
    """Map {-1,+1} -> {0,1}."""
    return (b > 0).to(torch.uint8)


def b01_to_pm1(b: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Map {0,1} -> {-1,+1}."""
    return (2 * b.to(torch.int32) - 1).to(dtype)


class _STESign(torch.autograd.Function):
    """sign() with the straight-through gradient clipped to |x| <= 1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return sign_pm1(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (torch.abs(x) <= 1.0).to(g.dtype)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """Forward: Eq. (1).  Backward: dL/dx = dL/dy * 1{|x| <= 1} (the
    BNN-standard straight-through estimator; a mask, not a kernel)."""
    return _STESign.apply(x)


def lq_scale(w: torch.Tensor, axis=None) -> torch.Tensor:
    """Per-output-channel scale alpha = E[|w|] (XNOR-Net / LQ-Nets
    style): the closed form of the rank-1 fit ``w ~= alpha * sign(w)``."""
    if axis is None:
        return torch.mean(torch.abs(w))
    return torch.mean(torch.abs(w), dim=axis, keepdim=True)


def binarize_weight(w: torch.Tensor, reduce_axis: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (sign_pm1(w), alpha) with alpha per output channel;
    ``reduce_axis`` is the contraction axis of the GEMM the weight feeds."""
    alpha = torch.mean(torch.abs(w), dim=reduce_axis, keepdim=True)
    return ste_sign(w), alpha


def binary_activation(z: torch.Tensor, z_max) -> torch.Tensor:
    """Paper Section II-A comparator on a bitcount z of an S-vector:
    ``compare(z, 0.5*z_max) = z > 0.5*z_max ? 1 : 0`` (uint8)."""
    return (z > 0.5 * z_max).to(torch.uint8)
