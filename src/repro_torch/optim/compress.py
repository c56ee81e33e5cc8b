"""Gradient compression: int8 quantization with error feedback, the JAX
package's ``repro.optim.compress``.

Gradients are quantized to int8 with a per-tensor scale before they
cross a slow link, and the quantization residual is carried into the
next step (error feedback), which keeps the long-run update unbiased
(Karimireddy et al., 2019): 4x fewer bytes on the wire.  ``wire_bytes``
reports the compressed against the raw traffic.  ``torch.round``
rounds half to even, as ``jnp.round`` does, so both packages give the
same bits on trees of the same leaves.  Each leaf has its own scale:
the port's trainable tree holds one leaf a layer where the JAX package
stacks a layer period into one, so on those trees the scales (and
``compressed_int8``, 4 bytes a leaf) differ.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def init_state(params):
    return T.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device), params)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress(grads, error_state):
    """Returns (wire tree with {"q", "scale"} leaves, new error state)."""
    wire, errs = [], []
    for g, e in zip(T.leaves(grads), T.leaves(error_state), strict=True):
        corrected = g.float() + e
        q, s = _quantize(corrected)
        wire.append({"q": q, "scale": s})
        errs.append(corrected - _dequantize(q, s))
    return T.unflatten(grads, wire), T.unflatten(grads, errs)


def _is_cell(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"} and \
        isinstance(x["q"], torch.Tensor)


def decompress(wire):
    """The float32 gradients of a wire tree."""
    if _is_cell(wire):
        return _dequantize(wire["q"], wire["scale"])
    if isinstance(wire, dict):
        return {k: decompress(v) for k, v in wire.items()}
    return type(wire)(decompress(v) for v in wire)


def roundtrip(grads, error_state):
    """The wire round trip: (grads_hat, new_error_state)."""
    wire, new_err = compress(grads, error_state)
    return decompress(wire), new_err


def wire_bytes(params) -> dict:
    leaves = T.leaves(params)
    raw = sum(p.numel() * 4 for p in leaves)
    comp = sum(p.numel() * 1 + 4 for p in leaves)
    return {"raw_fp32": raw, "compressed_int8": comp, "ratio": raw / comp}
