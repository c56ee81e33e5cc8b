"""Binarized 2-D convolution — the paper's actual workload (Sec. II-B).

A conv layer is lowered the way the XPC consumes it (Fig. 1): input
windows are flattened to vectors of S = kh*kw*C_in (im2col), weights to
(S, C_out), and the whole layer becomes ONE packed XNOR-bitcount GEMM —
each output pixel is one PCA bitcount result, optionally pushed through
the comparator to emit the next layer's binary activations.

Layouts and padding are the JAX package's (``core/patches.py``): NHWC
activations, HWIO weights flattened as ``w.reshape(S, C_out)`` with
patches in (kh, kw, C) order, JAX's asymmetric SAME.

Precision modes:
  bf16       plain float conv (the baseline path)
  bnn        packed XNOR-popcount: the patches binarized and packed
             straight from the NHWC input, the weight's packed words
             (cached per weight and version), the XNOR-popcount GEMM,
             and the SAME border term (cached too) subtracted (on a CUDA
             tensor the hand-written kernels, on a CPU tensor their
             plain versions; ``impl`` as ``kernels/ops.resolve_impl``)
  bnn_train  STE-binarized conv (differentiable): im2col of the float
             input, then ``core/xnor.bnn_matmul_train``; the padded
             zeros count as +1 (no border correction, as in the JAX
             package)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import patches, xnor
from repro_torch.core.binarize import sign_pm1
from repro_torch.kernels import ops


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: str) -> torch.Tensor:
    """Float conv of NHWC x with HWIO w, JAX padding; NHWC out."""
    kh, kw = w.shape[:2]
    xp = patches.pad(x, kh, kw, stride, padding).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def bnn_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               padding: str = "SAME", precision: str = "bnn",
               impl: str = "auto", scale: bool = False,
               binary_out: bool = False) -> torch.Tensor:
    """x: (B, H, W, C_in) float; w: (kh, kw, C_in, C_out) latent float.
    ``scale`` multiplies the bnn_train product by alpha = mean(|w|)
    over S per output channel (the other paths ignore it, as in the JAX
    package).

    Returns the {-1,+1} conv as integer-valued float32 (B, H', W', C_out),
    or, with ``binary_out=True``, the comparator's uint8 activations
    compare(z, S_eff/2), i.e. dot > 0 (paper Sec. II-A).
    """
    kh, kw, cin, cout = w.shape
    s = kh * kw * cin

    if precision == "bf16":
        return _conv_nhwc(x, w.to(x.dtype), stride, padding)
    if precision == "bnn_train":
        # im2col of the float input, then the STE GEMM; no SAME border
        # correction, as in the JAX package: a padded zero binarizes to
        # +1 (ste_sign(0) = +1), so border outputs differ from the bnn
        # path's (ROADMAP.md queue 3); binary_out is ignored there too
        cols = patches.im2col(x, kh, kw, stride, padding)
        b, ho, wo = cols.shape[:3]
        y = xnor.bnn_matmul_train(cols.reshape(b * ho * wo, s),
                                  w.reshape(s, cout), scale=scale)
        return y.reshape(b, ho, wo, cout)
    if precision != "bnn":
        raise ValueError(f"unknown precision {precision!r}")
    impl = ops.resolve_impl(impl, x)

    b, h, width = x.shape[:3]
    ho, wo = patches.out_size(h, width, kh, kw, stride, padding)
    ip = ops.pack_patches(x.float().contiguous(), kh, kw, stride, padding,
                          impl=impl)                         # (B*H'*W', Kw)
    wp = ops.pack_conv_weight(w, impl=impl)                  # (C_out, Kw)
    dot = ops.xnor_matmul(ip, wp, s, mode="dot", impl=impl)
    dot = dot.reshape(b, ho, wo, cout)

    if padding == "SAME" and (kh > 1 or kw > 1):
        # Border correction: SAME-padded zeros binarize to +1 in the
        # packed path (sign(0) = +1) but contribute 0 in the {-1,+1}
        # conv; on the XPC, border windows simply have shorter vectors
        # (Fig. 1).  The term depends on the weight and the input's
        # size only, so it is cached with them; the int32 dot and the
        # float32 term meet in one subtraction.
        border = ops.cached_per_weight(
            w, ("border", h, width, stride, padding),
            lambda wt: _border_term(wt, h, width, stride, padding))
        dot = dot - border
    else:
        dot = dot.float()

    if binary_out:
        return (dot > 0).to(torch.uint8)     # == compare(z, S_eff/2)
    return dot


def _border_term(w: torch.Tensor, h: int, width: int, stride: int,
                 padding: str) -> torch.Tensor:
    """(H', W', C_out) float32: what the SAME padding's +1 bits add to
    each output, sum(sign w) minus the sum over the taps that land inside
    the image.  The inside taps are the im2col of a one-channel ones
    image (1 inside, 0 in the padding) times sign(w) summed over C_in: a
    product of small integers, exact in float32."""
    kh, kw, _cin, cout = w.shape
    ws = sign_pm1(w.float()).sum(dim=2)                         # kh,kw,Cout
    ones = torch.ones((1, h, width, 1), device=w.device)
    inside = patches.im2col(ones, kh, kw, stride, padding) @ \
        ws.reshape(kh * kw, cout)                               # 1,H',W',Cout
    return (ws.sum(dim=(0, 1)) - inside)[0]


def reference_sign_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                          stride: int = 1,
                          padding: str = "SAME") -> torch.Tensor:
    """Oracle: float conv of sign(x) with sign(w) (the {-1,+1} math),
    computed directly — one float matmul per kernel tap over the padded
    sign image, summed.  Its sums are integers below 2**24, so it is
    exact in float32 in any order, on either device; cuDNN is not used
    because its Winograd and FFT algorithms round."""
    kh, kw = w.shape[:2]
    xs = patches.pad(sign_pm1(x.float()), kh, kw, stride, padding)
    ws = sign_pm1(w.float())
    ho = (xs.shape[1] - kh) // stride + 1
    wo = (xs.shape[2] - kw) // stride + 1
    y = torch.zeros((xs.shape[0], ho, wo, w.shape[3]), device=x.device)
    for i in range(kh):
        for j in range(kw):
            tap = xs[:, i:i + stride * (ho - 1) + 1:stride,
                     j:j + stride * (wo - 1) + 1:stride]
            y += tap @ ws[i, j]
    return y
