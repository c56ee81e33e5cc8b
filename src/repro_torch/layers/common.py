"""Shared model substrate: norms, rotary embeddings, dense projections,
parameter initialization.

Parameter trees are plain nested dicts of tensors, keyed as in the JAX
package.  Init functions draw from an explicit ``torch.Generator`` and
return the params only (the JAX package's logical-sharding specs and
activation constraints have no counterpart in the one-card port).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

# ---------------------------------------------------------------------------
# init helpers


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32,
               scale: float | None = None, device=None) -> dict:
    std = scale if scale is not None else (1.0 / d_in) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                    device=device) * std
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> dict:
    w = torch.randn((vocab, d), generator=gen, dtype=dtype,
                    device=device) * (1.0 / d) ** 0.5
    return {"w": w}


def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32,
              device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# ops


def rmsnorm(x: torch.Tensor, params, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm(x: torch.Tensor, params, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


def norm(x: torch.Tensor, params, kind: str = "rmsnorm",
         eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(x, params, eps) if kind == "rmsnorm" else \
        layernorm(x, params, eps)


def dense(x: torch.Tensor, params, precision: str = "bf16",
          impl: str = "auto", taps: list | None = None,
          name: str = "dense") -> torch.Tensor:
    """Projection with OXBNN precision dispatch (see kernels/ops.py).
    ``taps``, when a list, receives ``(name, input)``."""
    if taps is not None:
        taps.append((name, x))
    y = kops.bnn_dense(x, params["w"], precision=precision, impl=impl)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embedding (half of head_dim)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding.

    x: (..., T, H, Dh); positions: broadcastable to (..., T) int.
    Rotates pairs (x[2i], x[2i+1]), as the JAX package does.
    """
    inv = rope_frequencies(x.shape[-1], theta, x.device)       # (Dh/2,)
    ang = positions[..., None].float() * inv                    # (..., T, Dh/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., T, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")

