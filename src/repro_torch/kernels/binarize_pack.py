"""Binarize + bitpack: (M, S) float -> (M, ceil(S/32)) int32 words.

Bit j of word k is ``x[32k + j] >= threshold``; positions past S are
padded with -1.0 before the compare, as the Pallas kernel's wrapper
does (src/repro/kernels/binarize_pack.py).  Used to pack each BNN
weight once (kernels/ops.py).

``binarize_pack`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel (csrc/binarize_pack.cu) or raises; on a CPU tensor
it computes ``binarize_pack_torch``, the plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.kernels import _lib

KERNEL = _lib.KernelInfo(
    "binarize_pack", "src/repro_torch/csrc/binarize_pack.cu",
    "src/repro/kernels/binarize_pack.py:36")


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
                s, kw, float(threshold))
    KERNEL.launches += 1
    return out
