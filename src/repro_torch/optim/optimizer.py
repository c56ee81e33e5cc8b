"""AdamW with dtype-configurable moments, global-norm clipping and a
warm-up cosine schedule, the JAX package's ``repro.optim.optimizer``.

Everything is float32, in the JAX package's order of operations; the
moments are stored in ``moment_dtype`` (``torch.bfloat16`` for the
biggest models).  ``update`` keeps JAX's functional signature and
writes the new values into the given leaves in place (the params and
the moments): a tied head, a view of the embedding, stays tied.

A tree is the trainable params' (``models.transformer.trainable``):
nested dicts and lists of tensors, walked by ``repro_torch.tree``.

Over a mesh the leaves are DTensors (the params placed by the FSDP
train rules, their gradients placed alike): the moments are DTensors
placed as their params, ``update`` is elementwise on each rank's
shards, and ``global_norm`` sums each leaf's squares over the mesh dims
that cut it (a leaf held whole along a dim counts once), so the norm,
the clip scale, the step and the learning rate are the same on every
rank.  Writing a shard in place does not move its DTensor's
``_version``, which the per-weight caches read
(``kernels/ops.cached_per_weight``): ``update`` moves it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.dist import spmd


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32   # bf16 for the biggest models


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32: linear warm-up
    to ``lr_peak``, then a cosine down to ``lr_min_ratio`` x it."""
    step = step.float()
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def init(cfg: AdamWConfig, params) -> dict:
    """Zero moments shaped as ``params`` (placed as a DTensor param),
    step 0 (int32), on the params' device."""
    def zeros(p):
        z = torch.zeros(spmd.local(p).shape, dtype=cfg.moment_dtype,
                        device=p.device)
        return spmd.wrap_like(z, p)
    dev = T.leaves(params)[0].device
    return {"m": T.map_(zeros, params), "v": T.map_(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_state(cfg: AdamWConfig, param_shapes) -> dict:
    """The state of ``init`` as ``meta`` tensors (the dry-run)."""
    def zeros(p):
        return torch.empty(p.shape, dtype=cfg.moment_dtype, device="meta")
    return {"m": T.map_(zeros, param_shapes),
            "v": T.map_(zeros, param_shapes),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_specs(param_specs) -> dict:
    """Logical-axis spec tree of the optimizer state: the moments take
    their params' axes, the step is a scalar."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares,
    float32.  Of DTensor leaves, each rank's sums of its shards, summed
    over the mesh dims that cut the leaf: the leaves cut alike are
    summed in one collective a mesh dim."""
    groups: dict[tuple, list] = {}
    mesh = None
    for x in T.leaves(tree):
        dims = ()
        if spmd.is_dtensor(x):
            mesh = x.device_mesh
            dims = tuple(i for i, p in enumerate(x.placements)
                         if p.is_shard())
        groups.setdefault(dims, []).append(
            torch.sum(torch.square(spmd.local(x).float())))
    sums = []
    for dims, part in groups.items():
        t = torch.stack(part)
        for i in dims:
            t = spmd.all_reduce(t, mesh, i)
        sums.append(t)
    return torch.sqrt(torch.sum(torch.cat(sums)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params):
    """Returns (params, new_state, metrics {"grad_norm", "lr"}); the
    params and moments are updated in place (see the module
    docstring)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)

    for pd, g, m, v in zip(T.leaves(params), T.leaves(grads),
                           T.leaves(state["m"]), T.leaves(state["v"]),
                           strict=True):
        p, g, m, v = (spmd.local(t) for t in (pd, g, m, v))
        g = g.float() * scale
        mf = b1 * m.float() + (1 - b1) * g
        vf = b2 * v.float() + (1 - b2) * torch.square(g)
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
        if pd is not p:
            torch.autograd.graph.increment_version(pd)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
