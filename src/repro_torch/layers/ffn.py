"""Feed-forward blocks: GLU variants (SwiGLU/GeGLU) and plain MLPs,
with OXBNN precision dispatch on every projection.  Over a mesh the
gate and up projections are column-parallel and down row-parallel:
each rank's hidden is its slice of ``mlp``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import spmd
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


def specs(kind: str = "swiglu", axes=("embed", "mlp")) -> dict:
    """Logical axes of ``init``'s leaves."""
    s = {}
    if kind in ("swiglu", "geglu"):
        s["gate"] = C.dense_specs(axes)
    s["up"] = C.dense_specs(axes)
    s["down"] = C.dense_specs((axes[1], axes[0]))
    return s


def forward(params, x: torch.Tensor, kind: str = "swiglu",
            precision: str = "bf16", impl: str = "auto",
            taps: list | None = None) -> torch.Tensor:
    """``taps``, when a list, receives ``(name, input)`` of each
    projection."""
    def proj(v, name):
        return C.dense(v, params[name], precision, impl, taps, name)

    if kind == "swiglu":
        h = spmd.on_local(lambda g, u: F.silu(g) * u, proj(x, "gate"),
                          proj(x, "up"))
    elif kind == "geglu":
        h = spmd.on_local(lambda g, u: C.gelu(g) * u, proj(x, "gate"),
                          proj(x, "up"))
    elif kind == "gelu":
        h = spmd.on_local(C.gelu, proj(x, "up"))
    elif kind == "relu":
        h = spmd.on_local(F.relu, proj(x, "up"))
    else:
        raise ValueError(kind)
    h = C.lsc(h, "batch", None, "mlp")
    return proj(h, "down")
