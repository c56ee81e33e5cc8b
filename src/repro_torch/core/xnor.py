"""XNOR-bitcount vector-dot-products (paper Eq. 2) — reference
implementations on int32 words.

Identities:
  * {0,1} encoding:  z = bitcount(XNOR(I, W)) = #{k : I_k == W_k}
  * {-1,+1} encoding: dot(I, W) = 2*z - S   (S = vector size)

The packed path contracts over 32-bit words: popcount(~(iw ^ ww)).
Zero padding to a word multiple makes pad positions agree (0==0 ->
XNOR=1), so the padded bitcount overcounts by exactly (S_pad - S); we
subtract it.  The tiled kernels live in ``repro_torch.kernels``;
``bnn_matmul_train`` is the differentiable training GEMM (no kernel: a
float matmul of the STE signs, as in the JAX package).
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.binarize import sign_pm1, ste_sign


def xnor_bitcount_01(i01: torch.Tensor, w01: torch.Tensor) -> torch.Tensor:
    """Oracle: bitcount of elementwise XNOR over the last axis ({0,1} inputs)."""
    return torch.sum(i01.to(torch.int32) == w01.to(torch.int32), dim=-1,
                     dtype=torch.int32)


def dot_pm1(i_pm1: torch.Tensor, w_pm1: torch.Tensor) -> torch.Tensor:
    """Oracle: integer dot product of {-1,+1} vectors over the last axis."""
    return torch.sum(i_pm1.to(torch.int32) * w_pm1.to(torch.int32), dim=-1,
                     dtype=torch.int32)


def xnor_bitcount_packed(ip: torch.Tensor, wp: torch.Tensor,
                         s: int) -> torch.Tensor:
    """bitcount(XNOR) over packed int32 words (last axis), pad-corrected.

    ``s`` is the true (unpadded) vector length; the packed length is
    ``ceil(s/32)`` words.
    """
    z_pad = torch.sum(packing.popcount_u32(~(ip ^ wp)), dim=-1,
                      dtype=torch.int32)
    return z_pad - (ip.shape[-1] * packing.WORD_BITS - s)


# words of the (rows, N, Kw) XNOR temporary one block of rows may hold:
# the popcount widens it to int64 twice over, so a whole (M, N, Kw) at
# M = 128 and a 32928 x 8192 weight would take tens of GB
XNOR_BLOCK_WORDS = 1 << 26


def xnor_matmul_packed(ip: torch.Tensor, wp: torch.Tensor,
                       s: int) -> torch.Tensor:
    """Packed XNOR-bitcount 'matmul': (..., M, Kw) x (N, Kw) -> (..., M, N)
    int32.  Every output element is one PCA bitcount result.  Computed
    in blocks of rows of at most ``XNOR_BLOCK_WORDS`` temporary words
    (integer sums: the blocking changes no bit)."""
    rows = max(1, XNOR_BLOCK_WORDS // max(1, wp.numel()))
    m = ip.shape[-2]
    blocks = [ip[..., i:i + rows, :] for i in range(0, m, rows)] or [ip]
    pad = ip.shape[-1] * packing.WORD_BITS - s
    out = []
    for block in blocks:
        xnor = ~(block[..., :, None, :] ^ wp[None, :, :])
        out.append(torch.sum(packing.popcount_u32(xnor), dim=-1,
                             dtype=torch.int32) - pad)
    return out[0] if len(out) == 1 else torch.cat(out, dim=-2)


def bnn_matmul_train(x: torch.Tensor, w: torch.Tensor,
                     scale: bool = True) -> torch.Tensor:
    """Binarization-aware GEMM for training: y = (sign(x) @ sign(w)) *
    alpha, differentiable through the straight-through estimator.

    ``w`` has shape (K, N); alpha = mean(|w|, axis=0) is the
    per-output-channel LQ-Nets scale of the latent weight and stays in
    the autograd graph (w's gradient carries its sign(w)/K terms too).
    The product runs in float32 and is cast to x's dtype."""
    y = torch.matmul(ste_sign(x).float(), ste_sign(w).float())
    if scale:
        y = y * torch.mean(abs_jax(w.float()), dim=0, keepdim=True)
    return y.to(x.dtype)


def abs_jax(w: torch.Tensor) -> torch.Tensor:
    """|w| with JAX's derivative: +1 at w = 0, where ``torch.abs``'s is
    0 (the value is w * sign(w), the sign a constant of the graph)."""
    return w * sign_pm1(w)


def bnn_matmul_infer(x: torch.Tensor, w: torch.Tensor,
                     scale: bool = True) -> torch.Tensor:
    """Inference GEMM via packed XNOR-bitcount ({-1,+1} semantics).

    dot = 2*z - S, then optionally scaled by alpha = mean(|w|, axis=0).
    ``w`` has shape (K, N).
    """
    s = x.shape[-1]
    ip = packing.pack_pm1(x, axis=-1)
    wp = packing.pack_pm1(w, axis=0).transpose(-1, -2)   # (N, Kw)
    z = xnor_matmul_packed(ip, wp, s)
    y = (2 * z - s).to(torch.float32)
    if scale:
        y = y * torch.mean(torch.abs(w), dim=0, keepdim=True)
    return y.to(x.dtype) if x.is_floating_point() else y
