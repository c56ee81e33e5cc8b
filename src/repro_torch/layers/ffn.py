"""Feed-forward blocks: GLU variants (SwiGLU/GeGLU) and plain MLPs,
with OXBNN precision dispatch on every projection."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers import common as C


def init(gen: torch.Generator, d_model: int, d_ff: int, kind: str = "swiglu",
         dtype=torch.float32, device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    p = {}
    if kind in ("swiglu", "geglu"):
        p["gate"] = C.dense_init(gen, d_model, d_ff, **kw)
    p["up"] = C.dense_init(gen, d_model, d_ff, **kw)
    p["down"] = C.dense_init(gen, d_ff, d_model, **kw)
    return p


def forward(params, x: torch.Tensor, kind: str = "swiglu",
            precision: str = "bf16", impl: str = "auto",
            taps: list | None = None) -> torch.Tensor:
    """``taps``, when a list, receives ``(name, input)`` of each
    projection."""
    def proj(v, name):
        return C.dense(v, params[name], precision, impl, taps, name)

    if kind == "swiglu":
        h = F.silu(proj(x, "gate")) * proj(x, "up")
    elif kind == "geglu":
        h = C.gelu(proj(x, "gate")) * proj(x, "up")
    elif kind == "gelu":
        h = C.gelu(proj(x, "up"))
    elif kind == "relu":
        h = F.relu(proj(x, "up"))
    else:
        raise ValueError(kind)
    return proj(h, "down")
