"""Plain-torch oracles for the packed BNN kernels.

These mirror the kernel semantics exactly (including pad handling) and
are what the plain versions of the fused and packing kernels compute.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing, xnor

MODES = ("bitcount", "dot", "dot_scaled", "binary_act")


def epilogue(z: torch.Tensor, s: int, mode: str,
             alpha: torch.Tensor | None = None) -> torch.Tensor:
    """Turn pad-corrected bitcounts z (M, N) int32 into the mode's output:
      "bitcount"   z           (int32)            — the PCA readout
      "dot"        2z - s      (int32)            — {-1,+1} dot product
      "dot_scaled" (2z - s)*alpha (float32)       — LQ-Nets scaled GEMM
      "binary_act" z > s/2     (uint8)            — fused PCA comparator
    """
    if mode == "bitcount":
        return z
    if mode == "dot":
        return 2 * z - s
    if mode == "dot_scaled":
        if alpha is None:
            raise ValueError("dot_scaled needs alpha")
        return (2 * z - s).to(torch.float32) * alpha[None, :]
    if mode == "binary_act":
        return (2 * z > s).to(torch.uint8)
    raise ValueError(f"unknown mode {mode!r}")


def xnor_popcount_matmul_ref(ip: torch.Tensor, wp: torch.Tensor, s: int,
                             mode: str = "dot",
                             alpha: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Oracle for the packed XNOR-bitcount GEMM.

    ip: (M, Kw) int32 packed inputs; wp: (N, Kw) int32 packed weights;
    s: true contraction length (bits); ``mode`` as in ``epilogue``.
    """
    if ip.shape[1] != wp.shape[1]:
        raise ValueError(f"word counts differ: {ip.shape} vs {wp.shape}")
    return epilogue(xnor.xnor_matmul_packed(ip, wp, s), s, mode, alpha)


def binarize_pack_ref(x: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Oracle for the fused binarize+pack kernel: bit = (x >= threshold)."""
    return packing.pack_bits(x >= threshold, axis=-1)
