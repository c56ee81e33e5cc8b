"""Binarized 2-D convolution — the paper's actual workload (Sec. II-B).

A conv layer is lowered the way the XPC consumes it (Fig. 1): input
windows are flattened to vectors of S = kh*kw*C_in (im2col), weights to
(S, C_out), and the whole layer becomes ONE packed XNOR-bitcount GEMM —
each output pixel is one PCA bitcount result, optionally pushed through
the comparator to emit the next layer's binary activations.

Layouts are the JAX package's: NHWC activations, HWIO weights, flattened
as ``w.reshape(S, C_out)`` with patches in (kh, kw, C) order, so the
tests hand both packages the same arrays.

Padding is JAX's: "SAME" pads pad_total = max((ceil(in/s)-1)*s + k - in,
0) per spatial axis, pad_total // 2 low and the rest high — for a 3x3/2
conv on an even input that is (0, 1), not PyTorch's symmetric 1 — so
every pad here is explicit (``F.pad``); "VALID" pads nothing.

Precision modes:
  bf16       plain float conv (the baseline path)
  bnn        packed XNOR-popcount: binarize-pack of the patches and of
             the weights, then the XNOR-popcount GEMM (on a CUDA tensor
             the hand-written kernels, on a CPU tensor their plain
             versions; ``impl`` as ``kernels/ops.resolve_impl``)
  bnn_train  STE-binarized conv: not ported (raises)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import sign_pm1
from repro_torch.kernels import ops


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """JAX's SAME split of one spatial axis: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad(x: torch.Tensor, kh: int, kw: int, stride: int,
         padding: str) -> torch.Tensor:
    """Pad an NHWC tensor with zeros as JAX's ``padding`` would."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r} (SAME or VALID)")
    (hlo, hhi), (wlo, whi) = (_same_pads(x.shape[1], kh, stride),
                              _same_pads(x.shape[2], kw, stride))
    return F.pad(x, (0, 0, wlo, whi, hlo, hhi))


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
            padding: str) -> torch.Tensor:
    """x: (B, H, W, C) -> patches (B, H', W', kh*kw*C), in (kh, kw, C)
    order to match the flattened HWIO weight.  ``Tensor.unfold`` (like
    JAX's ``conv_general_dilated_patches`` and ``F.unfold``) yields each
    window channel-major, (C, kh, kw); it is reordered here."""
    xp = _pad(x, kh, kw, stride, padding)
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)   # B,H',W',C,kh,kw
    b, ho, wo, c = win.shape[:4]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(b, ho, wo, kh * kw * c)


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: str) -> torch.Tensor:
    """Float conv of NHWC x with HWIO w, JAX padding; NHWC out."""
    kh, kw = w.shape[:2]
    xp = _pad(x, kh, kw, stride, padding).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def bnn_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               padding: str = "SAME", precision: str = "bnn",
               impl: str = "auto", binary_out: bool = False) -> torch.Tensor:
    """x: (B, H, W, C_in) float; w: (kh, kw, C_in, C_out) latent float.

    Returns the {-1,+1} conv as integer-valued float32 (B, H', W', C_out),
    or, with ``binary_out=True``, the comparator's uint8 activations
    compare(z, S_eff/2), i.e. dot > 0 (paper Sec. II-A).
    """
    kh, kw, cin, cout = w.shape
    s = kh * kw * cin

    if precision == "bf16":
        return _conv_nhwc(x, w.to(x.dtype), stride, padding)
    if precision == "bnn_train":
        raise NotImplementedError(
            "precision='bnn_train' (STE training) is not ported "
            "(ROADMAP.md queue 1, item 10)")
    if precision != "bnn":
        raise ValueError(f"unknown precision {precision!r}")
    impl = ops.resolve_impl(impl, x)

    patches = _im2col(x.float(), kh, kw, stride, padding)      # (B,H',W',S)
    b, ho, wo, _ = patches.shape
    ip = ops.pack_activations(patches.reshape(b * ho * wo, s), impl=impl)
    wp = ops.pack_activations(w.float().reshape(s, cout).t().contiguous(),
                              impl=impl)
    dot = ops.xnor_matmul(ip, wp, s, mode="dot", impl=impl)
    dot = dot.reshape(b, ho, wo, cout).float()

    if padding == "SAME" and (kh > 1 or kw > 1):
        # Border correction: SAME-padded zeros binarize to +1 in the
        # packed path (sign(0) = +1) but contribute 0 in the {-1,+1}
        # conv; on the XPC, border windows simply have shorter vectors
        # (Fig. 1).  Padded contribution per output = sum(sign w) minus
        # the sum over the taps that land inside the image.  The inside
        # taps are the im2col of a one-channel ones image (1 inside, 0
        # in the padding) times sign(w) summed over C_in: a product of
        # small integers, exact in float32.
        ws = sign_pm1(w.float()).sum(dim=2)                      # kh,kw,Cout
        ones = torch.ones((1, x.shape[1], x.shape[2], 1), device=x.device)
        inside = _im2col(ones, kh, kw, stride, padding) @ \
            ws.reshape(kh * kw, cout)                            # 1,H',W',Cout
        dot = dot - (ws.sum(dim=(0, 1)) - inside)

    if binary_out:
        return (dot > 0).to(torch.uint8)     # == compare(z, S_eff/2)
    return dot


def reference_sign_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                          stride: int = 1,
                          padding: str = "SAME") -> torch.Tensor:
    """Oracle: float conv of sign(x) with sign(w) (the {-1,+1} math),
    computed directly — one float matmul per kernel tap over the padded
    sign image, summed.  Its sums are integers below 2**24, so it is
    exact in float32 in any order, on either device; cuDNN is not used
    because its Winograd and FFT algorithms round."""
    kh, kw = w.shape[:2]
    xs = _pad(sign_pm1(x.float()), kh, kw, stride, padding)
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
