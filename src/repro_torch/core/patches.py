"""Convolution patches in the JAX package's layout and padding.

NHWC activations, HWIO weights; a patch is flattened in (kh, kw, C)
order, as ``w.reshape(S, C_out)`` of the HWIO weight, so the tests hand
both packages the same arrays.

Padding is JAX's: "SAME" pads pad_total = max((ceil(in/s)-1)*s + k - in,
0) per spatial axis, pad_total // 2 low and the rest high — for a 3x3/2
conv on an even input that is (0, 1), not PyTorch's symmetric 1 — so
every pad here is explicit; "VALID" pads nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """JAX's SAME split of one spatial axis: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pads(h: int, w: int, kh: int, kw: int, stride: int, padding: str
         ) -> tuple[tuple[int, int], tuple[int, int]]:
    """((top, bottom), (left, right)) zero padding of an H x W input."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r} (SAME or VALID)")
    return same_pads(h, kh, stride), same_pads(w, kw, stride)


def out_size(h: int, w: int, kh: int, kw: int, stride: int,
             padding: str) -> tuple[int, int]:
    """(H', W') of a conv's output."""
    (top, bottom), (left, right) = pads(h, w, kh, kw, stride, padding)
    return ((h + top + bottom - kh) // stride + 1,
            (w + left + right - kw) // stride + 1)


def pad(x: torch.Tensor, kh: int, kw: int, stride: int,
        padding: str) -> torch.Tensor:
    """Pad an NHWC tensor with zeros as JAX's ``padding`` would."""
    (top, bottom), (left, right) = pads(x.shape[1], x.shape[2], kh, kw,
                                        stride, padding)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (0, 0, left, right, top, bottom))


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
           padding: str) -> torch.Tensor:
    """x: (B, H, W, C) -> patches (B, H', W', kh*kw*C), in (kh, kw, C)
    order to match the flattened HWIO weight.  ``Tensor.unfold`` (like
    JAX's ``conv_general_dilated_patches`` and ``F.unfold``) yields each
    window channel-major, (C, kh, kw); it is reordered here."""
    xp = pad(x, kh, kw, stride, padding)
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)   # B,H',W',C,kh,kw
    b, ho, wo, c = win.shape[:4]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(b, ho, wo, kh * kw * c)
