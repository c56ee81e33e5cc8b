"""Binarize + bitpack: (M, S) float -> (M, ceil(S/32)) int32 words, and
the same of a convolution's patch rows read from its NHWC input.

Bit j of word k is ``x[32k + j] >= threshold``; positions past S are
padded with -1.0 before the compare, as the Pallas kernel's wrapper
does (src/repro/kernels/binarize_pack.py).  Used to pack each BNN
weight once (kernels/ops.py) and, through ``pack_patches``, the patches
of every binarized conv layer (core/conv.py): row (b, oy, ox) of the
patch matrix is the window ``core/patches.im2col`` flattens in (kh, kw,
C) order, under JAX's SAME or VALID padding.  Two padding rules meet
there: a tap in the spatial padding is a 0.0 input (its bit is
``0.0 >= threshold``), a word position past S the -1.0 pad.

``binarize_pack`` and ``pack_patches`` are the wrappers: on a CUDA
tensor each launches its hand-written kernel (csrc/binarize_pack.cu) or
raises; on a CPU tensor it computes ``binarize_pack_torch`` /
``pack_patches_torch``, the plain version (the patch matrix written
out, then packed).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import packing, patches
from repro_torch.kernels import _lib

_REPLACES = "src/repro/kernels/binarize_pack.py:36"
KERNEL = _lib.KernelInfo(
    "binarize_pack", "src/repro_torch/csrc/binarize_pack.cu", _REPLACES)
KERNEL_PATCHES = _lib.KernelInfo(
    "pack_patches", "src/repro_torch/csrc/binarize_pack.cu", _REPLACES)


def binarize_pack_torch(x: torch.Tensor, threshold: float = 0.0
                        ) -> torch.Tensor:
    """Plain version: pad S to a word multiple with -1.0, compare, pack."""
    pad = (-x.shape[-1]) % packing.WORD_BITS
    xp = F.pad(x, (0, pad), value=-1.0)
    return packing.pack_bits(xp >= threshold, axis=-1)


def binarize_pack(x: torch.Tensor, *, threshold: float = 0.0) -> torch.Tensor:
    """(M, S) float32 -> (M, ceil(S/32)) int32 packed sign bits."""
    if x.device.type == "cpu":
        return binarize_pack_torch(x, threshold)
    if x.device.type != "cuda":
        raise ValueError(f"binarize_pack: no kernel for device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"binarize_pack: x must be (M, S), got {tuple(x.shape)}")
    m, s = x.shape
    _lib.check(x, "x", torch.float32, (m, s), x.device)
    kw = packing.packed_len(s)
    out = torch.empty((m, kw), dtype=torch.int32, device=x.device)
    _lib.launch("bp_binarize_pack", x.device, _lib.ptr(x), _lib.ptr(out), m,
                s, kw, float(threshold), _lib.sm_count(x.device))
    KERNEL.launches += 1
    return out


def pack_patches_torch(x: torch.Tensor, kh: int, kw: int, stride: int,
                       padding: str, *, threshold: float = 0.0
                       ) -> torch.Tensor:
    """Plain version: the patch matrix (``patches.im2col``), then
    ``binarize_pack_torch``."""
    p = patches.im2col(x.float(), kh, kw, stride, padding)
    b, ho, wo, s = p.shape
    return binarize_pack_torch(p.reshape(b * ho * wo, s), threshold)


def pack_patches(x: torch.Tensor, kh: int, kw: int, stride: int,
                 padding: str, *, threshold: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) float32 NHWC -> (B*H'*W', ceil(kh*kw*C/32)) int32
    packed sign bits of its conv patches, no patch matrix in memory."""
    if x.device.type == "cpu":
        return pack_patches_torch(x, kh, kw, stride, padding,
                                  threshold=threshold)
    if x.device.type != "cuda":
        raise ValueError(f"pack_patches: no kernel for device {x.device}")
    if x.ndim != 4 or min(kh, kw, stride) < 1:
        raise ValueError(f"pack_patches: x must be (B, H, W, C) and kh, kw, "
                         f"stride positive, got {tuple(x.shape)}, {kh}, "
                         f"{kw}, {stride}")
    b, h, w, c = x.shape
    _lib.check(x, "x", torch.float32, (b, h, w, c), x.device)
    (top, _), (left, _) = patches.pads(h, w, kh, kw, stride, padding)
    ho, wo = patches.out_size(h, w, kh, kw, stride, padding)
    ho, wo = max(ho, 0), max(wo, 0)
    words = packing.packed_len(kh * kw * c)
    out = torch.empty((b * ho * wo, words), dtype=torch.int32,
                      device=x.device)
    _lib.launch("bp_pack_patches", x.device, _lib.ptr(x), _lib.ptr(out), b,
                h, w, c, kh, kw, stride, top, left, ho, wo, words,
                float(threshold), _lib.sm_count(x.device))
    KERNEL_PATCHES.launches += 1
    return out
