"""Shared model substrate: norms, rotary embeddings, dense projections,
parameter initialization, logical sharding axes.

Parameter trees are plain nested dicts of tensors, keyed as in the JAX
package.  Init functions draw from an explicit ``torch.Generator`` and
return the params; beside each, a ``*_specs`` function returns the
same tree with a tuple of LOGICAL axis names per leaf (the JAX
package's init returns both).  ``logical_to_pspec`` resolves such a
tuple to mesh axes under a rule set (``dist/sharding.py``), and
``to_placements`` turns the result into DTensor placements.

Activations are annotated through ``lsc`` (logical sharding
constraint), the JAX package's: outside a sharding context it returns
its input; inside one it redistributes the activation (a DTensor, or a
plain tensor every rank holds whole) to the placements its logical
axes resolve to on the context's mesh.  Under a mesh the ops here take
DTensors and compute on each rank's shard (``dist/spmd.py``).
"""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Mapping
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import spmd
from repro_torch.kernels import ops as kops

# ---------------------------------------------------------------------------
# logical sharding context


class _ShardingContext(threading.local):
    def __init__(self):
        self.rules: dict[str, Any] | None = None
        self.mesh = None


_CTX = _ShardingContext()


def set_sharding_context(mesh, rules: dict[str, Any] | None):
    _CTX.mesh = mesh
    _CTX.rules = rules


def clear_sharding_context():
    _CTX.mesh = None
    _CTX.rules = None


@contextlib.contextmanager
def sharding_context(mesh, rules: dict[str, Any] | None):
    """Scoped set/restore of the logical sharding context: nesting
    restores the enclosing context, not clears it."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    set_sharding_context(mesh, rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


# ---------------------------------------------------------------------------
# logical sharding axes


def mesh_axes(mesh) -> Mapping[str, int]:
    """Axis name -> size of ``mesh``: a ``DeviceMesh`` (names and shape
    zipped), or any object whose ``.shape`` is already such a mapping
    (a JAX mesh, a test's stand-in)."""
    if isinstance(mesh.shape, Mapping):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))


def logical_to_pspec(axes: tuple[str | None, ...], rules: dict[str, Any],
                     shape: tuple[int, ...] | None = None, mesh=None
                     ) -> tuple:
    """Resolve logical axis names to a partition spec: per tensor dim a
    mesh-axis name, a tuple of them, or None (the JAX package's
    ``PartitionSpec`` entries, as a plain tuple).

    Robustness rules (one rule set serves every arch), as in the JAX
    package:
      * dedup: a mesh axis may appear only once per spec (first wins);
      * divisibility: when ``shape`` and ``mesh`` are given, a mesh axis
        is dropped if it does not divide the dim (e.g. 24 heads on a
        16-way 'model' axis, 8 Mixtral experts on 16-way EP).
    """
    sizes = mesh_axes(mesh) if mesh is not None else None
    used: set = set()
    out = []
    for i, a in enumerate(axes):
        mx = rules.get(a) if a else None
        if mx is None:
            out.append(None)
            continue
        parts = mx if isinstance(mx, tuple) else (mx,)
        parts = tuple(p for p in parts if p not in used)
        if not parts:
            out.append(None)
            continue
        if shape is not None and sizes is not None:
            size = 1
            for p in parts:
                size *= sizes[p]
            if shape[i] % size != 0:
                out.append(None)
                continue
        used.update(parts)
        out.append(parts if len(parts) > 1 else parts[0])
    return tuple(out)


def to_placements(spec: tuple, mesh) -> list:
    """A partition spec (``logical_to_pspec``) as DTensor placements, one
    per mesh dim: ``Shard(d)`` where tensor dim d names the mesh dim,
    else ``Replicate()``.  A dim that names two mesh dims (("pod",
    "data")) is sharded on both, the first named the outer one, as a
    JAX ``PartitionSpec`` lays it out."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def lsc(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Logical sharding constraint on an activation: without a context
    ``x`` itself; within one, ``x`` redistributed to its axes' placements
    on the context's mesh (a plain ``x`` is taken as held whole on every
    rank)."""
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    mesh = _CTX.mesh
    if not spmd.is_dtensor(x):
        x = spmd.replicate(x, mesh)
    spec = logical_to_pspec(axes[:x.ndim], _CTX.rules, tuple(x.shape), mesh)
    return spmd.redistribute(x, to_placements(spec, mesh))


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


def dense_specs(axes: tuple[str | None, str | None],
                bias: bool = False) -> dict:
    """Logical axes of ``dense_init``'s leaves."""
    s = {"w": tuple(axes)}
    if bias:
        s["b"] = (axes[1],)
    return s


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> dict:
    w = torch.randn((vocab, d), generator=gen, dtype=dtype,
                    device=device) * (1.0 / d) ** 0.5
    return {"w": w}


def embed_specs() -> dict:
    return {"w": ("vocab", "embed")}


def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32,
              device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_specs(kind: str = "rmsnorm") -> dict:
    s = {"scale": ("embed",)}
    if kind == "layernorm":
        s["bias"] = ("embed",)
    return s


# ---------------------------------------------------------------------------
# ops


def rmsnorm(x: torch.Tensor, params, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, float32, one fixed order a row
    (``kernels/ops.row_norm``)."""
    return kops.row_norm(x, params["scale"], eps=eps,
                         kind="rmsnorm").to(x.dtype)


def layernorm(x: torch.Tensor, params, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim (bias optional), float32, one fixed
    order a row (``kernels/ops.row_norm``)."""
    return kops.row_norm(x, params["scale"], params.get("bias"), eps=eps,
                         kind="layernorm").to(x.dtype)


def norm(x: torch.Tensor, params, kind: str = "rmsnorm",
         eps: float = 1e-6) -> torch.Tensor:
    """Over the last dim, which a DTensor ``x`` holds whole: each rank
    normalizes its own rows (a row's bits are one rank's whatever rows
    run beside it)."""
    fn = rmsnorm if kind == "rmsnorm" else layernorm
    p = {k: spmd.local(v) for k, v in params.items()}
    return spmd.on_local(fn, x, p, eps)


def dense(x: torch.Tensor, params, precision: str = "bf16",
          impl: str = "auto", taps: list | None = None,
          name: str = "dense") -> torch.Tensor:
    """Projection with OXBNN precision dispatch (see kernels/ops.py).
    ``taps``, when a list, receives ``(name, input)``."""
    if taps is not None:
        taps.append((name, x))
    y = kops.bnn_dense(x, params["w"], precision=precision, impl=impl)
    if "b" in params:
        y = spmd.on_local(lambda yl, b: yl + b.to(yl.dtype), y, params["b"])
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

