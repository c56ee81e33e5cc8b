"""Logical-axis sharding rules, tree-wide placement plans, and the
devices of the data-axis serving shards.

A rule set maps LOGICAL axis names (the tuples of the param and cache
spec trees, ``models/transformer.param_specs`` / ``cache_specs``) to
mesh axes.  One rule set serves every arch; per-tensor robustness
(dedup, divisibility) lives in ``layers.common.logical_to_pspec``.
A resolved spec becomes DTensor placements (``Shard(dim)`` /
``Replicate()`` per mesh dim, ``layers.common.to_placements``) over a
``DeviceMesh`` (``launch/mesh.py``).  The rules and resolution are the
JAX package's ``repro.dist.sharding``.  ``place_params`` puts a params
tree on a mesh as DTensors, the counterpart of the JAX package's
``jax.device_put(params, param_shardings(...))``, and the forward over
several ranks runs on them (``dist/spmd.py``); ``gather_tree`` brings
such a tree back whole.  The dry-run places ``meta`` tensors.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod (see launch/mesh.py).

``shard_devices`` is the counterpart of the JAX package's
``shard_meshes``: each shard of a ``ShardedEngine`` gets one device.  A
shard is an isolation domain first (its own ``Engine``: pools, block
tables, prefix and snapshot indexes) and hardware second, so with fewer
devices than shards the list is tiled and several shards share a
device, as in the JAX package's single-device tests."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.dist import spmd
from repro_torch.layers.common import logical_to_pspec, to_placements


def _dp(multi_pod: bool):
    """The data-parallel submesh (batch axis)."""
    return ("pod", "data") if multi_pod else "data"


def _base_rules(multi_pod: bool) -> dict[str, Any]:
    return {
        # activations
        "batch": _dp(multi_pod),
        "heads_dim": "model",
        "kv_heads_dim": "model",
        "head_dim": "model",     # fallback when head count won't divide
        # params
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "kv_lora": "model",
        "q_lora": "model",
        "ssm_heads": "model",
        "ssm_inner": "model",
        # the JAX package's scan-stacked layer axis (never sharded; the
        # port keeps one dict per layer and has no such axis)
        "layers": None,
    }


def rules_train(multi_pod: bool, fsdp: bool = False) -> dict[str, Any]:
    """Training rules: TP over 'model'; FSDP additionally shards the
    embed dim of params over the data axis (gathered per layer)."""
    r = _base_rules(multi_pod)
    r["embed"] = _dp(multi_pod) if fsdp else None
    return r


def rules_decode(multi_pod: bool) -> dict[str, Any]:
    """Decode rules: replicated embed (the latency path re-gathers
    nothing), batch over data, TP over model."""
    r = _base_rules(multi_pod)
    r["embed"] = None
    return r


def train_rules_of(mesh) -> dict[str, Any]:
    """The FSDP train rules of ``mesh``'s layout (multi-pod when it has
    a "pod" dim): what training over it places the params by, as the
    JAX launcher's ``rules_train(multi_pod, fsdp=True)``."""
    return rules_train("pod" in mesh.mesh_dim_names, fsdp=True)


def decode_rules_of(mesh) -> dict[str, Any]:
    """The decode rules of ``mesh``'s layout (multi-pod when it has a
    "pod" dim): what a serve over it places and constrains by."""
    return rules_decode("pod" in mesh.mesh_dim_names)


def state_rules_of(mesh) -> dict[str, Any]:
    """The rules the port places its caches and pools by: ``mesh``'s
    decode rules without the ``head_dim``, ``kv_lora`` and ``ssm_inner``
    splits.  A rank's K and V are whole heads (RoPE rotates pairs across
    a head, so a projection cut inside a head is gathered before it),
    and the MLA kernel absorbs k_up and takes its softmax over the whole
    latent, so the latent pools are whole on every model rank.  An SSM
    layer's conv tail is whole on every model rank too: ``in_proj``'s
    output is gathered whole before the conv (``layers/mamba2.py``), so
    every rank holds the whole x B C it shifts in; its state ``h`` is cut
    by ``ssm_heads``, as the JAX package's is.  The JAX package's
    ``cache_specs`` name all three dims, and its caches are cut along
    them where a head count does not divide the model axis (GQA) or
    always (MLA's ``kv_lora``, the conv tail's ``ssm_inner``).  The
    engine's pools also hold every block and slot on every data rank
    (a block or slot id is global), where JAX's ``h`` and conv specs
    cut the batch over ``data``: ``paged_state_specs`` name no batch
    axis."""
    r = decode_rules_of(mesh)
    r["head_dim"] = None
    r["kv_lora"] = None
    r["ssm_inner"] = None
    return r


def is_axes(x) -> bool:
    """A spec tree's leaf: a tuple of logical axis names (or None)."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_specs(fn, specs, *trees):
    """``fn(axes, *leaves)`` at every leaf of the spec tree ``specs``,
    with the leaves of ``trees`` at the same keys (trees shaped as
    ``specs``: the params' ``trainable`` tree, the caches)."""
    if is_axes(specs):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(specs)]
    raise TypeError(f"not a spec tree: {type(specs)}")


def param_pspecs(mesh, shapes, specs, rules: dict[str, Any]):
    """A partition-spec tuple per leaf (``logical_to_pspec``), shaped as
    ``specs``; ``shapes`` mirrors it with tensors (``meta`` ones in the
    dry-run)."""
    return map_specs(lambda axes, s: logical_to_pspec(
        tuple(axes), rules, tuple(s.shape), mesh), specs, shapes)


def param_shardings(mesh, shapes, specs, rules: dict[str, Any]):
    """DTensor placements per leaf over the ``DeviceMesh`` ``mesh``,
    shaped as ``specs``."""
    return map_specs(lambda axes, s: to_placements(logical_to_pspec(
        tuple(axes), rules, tuple(s.shape), mesh), mesh), specs, shapes)


def place_tree(tree, specs, mesh, rules: dict[str, Any]):
    """``tree``'s leaves as DTensors over ``mesh``, each placed by its
    logical axes in ``specs`` under ``rules`` (``logical_to_pspec``'s
    divisibility rule); every rank holds the whole tree and keeps its
    slices, so no collective runs (``spmd.place``)."""
    return map_specs(lambda axes, t: spmd.place(t, mesh, to_placements(
        logical_to_pspec(tuple(axes), rules, tuple(t.shape), mesh), mesh)),
        specs, tree)


def place_params(params, cfg, mesh, rules: dict[str, Any] | None = None
                 ) -> dict:
    """The params (whole on every rank: one seed, or one converted
    tree) as DTensors over ``mesh`` by ``transformer.param_specs`` under
    ``rules`` (default: its decode rules; training passes
    ``train_rules_of``, which cut ``embed`` over the data dims too).  A
    tied head is the transpose of the placed embedding, so it is
    sharded through it and never copied (``head_matrix``)."""
    from repro_torch.models import transformer as M
    placed = place_tree(M.trainable(params, cfg), M.param_specs(cfg), mesh,
                        rules or decode_rules_of(mesh))
    if cfg.tie_embeddings:
        placed["head"] = {"w": spmd.transpose(placed["embed"]["w"])}
    return {k: placed[k] for k in params}


def placed(params, cfg, mesh, rules: dict[str, Any] | None = None) -> dict:
    """``params`` placed on ``mesh`` (``place_params``, by ``rules``)
    unless they are DTensors already."""
    if spmd.is_dtensor(params["embed"]["w"]):
        return params
    return place_params(params, cfg, mesh, rules)


def replace_params(params, cfg, mesh, rules: dict[str, Any]) -> dict:
    """DTensor ``params`` moved to the placements ``rules`` give them
    (trained FSDP shards to the decode rules: gathers over the data
    dims, exact) as new tensors; a tied head the new embedding's
    transpose."""
    from repro_torch.models import transformer as M
    def move(axes, t):
        pl = to_placements(logical_to_pspec(tuple(axes), rules,
                                            tuple(t.shape), mesh), mesh)
        return spmd.wrap(spmd.redistribute(t, pl).to_local().clone(), mesh,
                         pl, t.shape)
    with torch.no_grad():
        out = map_specs(move, M.param_specs(cfg), M.trainable(params, cfg))
    if cfg.tie_embeddings:
        out["head"] = {"w": spmd.transpose(out["embed"]["w"])}
    return {k: out[k] for k in params}


def gather_tree(tree):
    """A tree of DTensors (and plain leaves) as plain tensors, each held
    whole (``spmd.full``); a tied head becomes a copy."""
    return T.map_(spmd.full, tree)


def batch_axes(ndim: int) -> tuple:
    """A batch leaf's logical axes: "batch" on its leading dim (a 0-dim
    leaf, the decode step's scalar length, is replicated)."""
    return (("batch",) + (None,) * ndim)[:ndim]


def batch_pspecs(mesh, bspec: dict, rules: dict[str, Any]) -> dict:
    """A partition-spec tuple per batch leaf: sharded along its leading
    (batch) dim."""
    return {k: logical_to_pspec(batch_axes(v.ndim), rules, tuple(v.shape),
                                mesh) for k, v in bspec.items()}


def batch_shardings(mesh, bspec: dict, rules: dict[str, Any]) -> dict:
    """DTensor placements per batch leaf (``batch_pspecs``)."""
    return {k: to_placements(s, mesh)
            for k, s in batch_pspecs(mesh, bspec, rules).items()}


def replicated(mesh) -> list:
    """Placements of a leaf held whole on every device."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def shard_devices(n_shards: int, *, devices=None) -> list[torch.device]:
    """One ``torch.device`` per shard: the lead of a disjoint slice of
    ``devices`` when there are at least ``n_shards`` of them, else the
    list tiled round-robin (the JAX package's rule).  ``devices``
    defaults to every CUDA device; without a card that raises rather
    than carry on on the CPU (pass ``devices=[torch.device("cpu")]``)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "shard_devices: no CUDA device — pass devices=["
                "torch.device('cpu')] to run the shards on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("shard_devices: empty device list")
    if len(devices) >= n_shards:
        per = len(devices) // n_shards
        return [devices[i * per] for i in range(n_shards)]
    return [devices[i % len(devices)] for i in range(n_shards)]
