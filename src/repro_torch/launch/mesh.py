"""Production meshes and the process groups under them.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
current process group: (16, 16) with dims ("data", "model") for one pod
of 256 devices, (2, 16, 16) with ("pod", "data", "model") for two pods.
Building one needs a group of exactly that many ranks, as the JAX
package's ``jax.make_mesh`` needs the devices.  Functions, not
module-level constants, so importing this module touches no
process-group state.

Without the devices, the dry-run runs under ``fake_world``: torch's
fake process group, whose collectives do nothing, in place of the JAX
package's ``--xla_force_host_platform_device_count=512``.  ``local_world``
is a group of one rank (``gloo`` on the CPU, ``nccl`` on the card), the
counterpart of a one-device mesh.  ``rank_world`` is one rank of a real
group of several processes, and ``spawn_ranks`` starts such a group
and collects what each rank returns: the forward over several ranks
runs there, over a mesh of the group's ranks.  A process group is
global state, so each of these is a context manager that destroys the
group it made.

``init_on_ranks`` draws a model's seeded weights on every rank and
keeps the rank's slices one layer at a time, so no rank holds more
than one layer whole; ``rank_weight_bytes`` reckons those slices'
bytes from the configuration alone, before anything is drawn, and
beside them what a rank caches at first use (``CACHED_KINDS``): the
columns of its heads of MLA's k_up/v_up, an SSM layer's whole conv
weight, conv bias and norm scale.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist


def mesh_layout(multi_pod: bool) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, dim names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def n_devices(multi_pod: bool) -> int:
    return math.prod(mesh_layout(multi_pod)[0])


def _fresh():
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process; destroy it first")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks, this process rank 0, whose
    collectives do nothing (the dry-run's stand-in for the devices)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _fresh()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def local_world(device="cpu"):
    """A process group of one rank over ``device``: ``gloo`` on the CPU,
    ``nccl`` on a card."""
    dev = torch.device(device)
    _fresh()
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


COLLECTIVE_TIMEOUT_S = 120.0   # a rank that waits longer raises


@dataclass(frozen=True)
class RankWorld:
    """What ``rank_world`` made: this process's ``rank`` of ``size``, the
    ``device`` its kernels run on and the group's ``backend``."""
    rank: int
    size: int
    device: torch.device
    backend: str


@contextlib.contextmanager
def rank_world(rank: int, size: int, init_file: str, device="cpu"):
    """A process group of ``size`` processes, this one rank ``rank``,
    met through a ``file://`` store at ``init_file`` (a path every rank
    names under one temporary directory: no port to collide with).  On
    the CPU ``gloo``.  On a card ``nccl``, one rank a card, where there
    are at least ``size`` cards; else the ranks share the cards (rank r
    on card r % count) under ``gloo``, since NCCL refuses two ranks on
    one device: gloo runs the collectives on the cards' tensors (it
    copies them through host memory itself), and the kernels still run
    on the card.  A collective that waits longer than
    ``COLLECTIVE_TIMEOUT_S`` raises."""
    _fresh()
    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        dev = torch.device("cuda", rank % n)
        torch.cuda.set_device(dev)
        if n >= size:
            backend = "nccl"
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        yield RankWorld(rank, size, dev, backend)
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, size: int, tmp: str, device, fn, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    with rank_world(rank, size, os.path.join(tmp, "store"), device) as world:
        out = fn(world, *args)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def spawn_ranks(fn, size: int, *args, device="cpu",
                timeout_s: float = 600.0) -> list:
    """``fn(world, *args)`` in ``size`` fresh processes (the ``spawn``
    start method), each inside ``rank_world`` (a ``RankWorld`` is
    ``world``); returns what each returned, in rank order.  ``fn`` is a
    module-level function (it is pickled by name) and its result
    something ``torch.save`` writes.  A rank that raises ends the others
    and its error is raised here; so is a run past ``timeout_s``.  A
    CPU rank computes on one thread.  Build any kernel before, in the
    caller: the ranks load the built library."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(size, tmp, device, fn, args),
                                 nprocs=size, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn_ranks: {size} ranks still "
                                       f"running after {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(size)]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod.
    Raises unless the current process group has exactly that many
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = mesh_layout(multi_pod)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise ValueError(f"need a process group of {n} ranks for the "
                         f"{shape} mesh, have {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def launch_mesh(*, smoke: bool = False, multi_pod: bool = False,
                device="cpu", mesh=None):
    """The mesh a launcher (serve, train) runs over: ``mesh`` when given;
    a non-smoke run under a process group, or one asked for
    ``multi_pod``, the production mesh (``make_production_mesh``: it
    raises unless the group has 256 ranks, 512 with ``multi_pod``), as
    the JAX launchers build it; else None (one device, the JAX
    package's smoke mesh)."""
    if mesh is not None or smoke:
        return mesh
    if dist.is_initialized() or multi_pod:
        return make_production_mesh(multi_pod=multi_pod,
                                    device_type=torch.device(device).type)
    return None


def make_mesh_for(devices, *, multi_pod: bool = False,
                  device_type: str = "cpu"):
    """Mesh over an explicit list of ranks of the current group (the
    elastic re-mesh path: after a failure the surviving ranks are
    re-meshed, see ``dist/fault.py``); the first 256 or 512 are used."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = mesh_layout(multi_pod)
    n = math.prod(shape)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, got {len(devices)}")
    ranks = torch.tensor([int(d) for d in devices[:n]]).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


@contextlib.contextmanager
def smoke_mesh(device="cpu"):
    """A 1x1 ("data", "model") mesh over ``device``, inside a
    ``local_world`` group that ends with the block."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    with local_world(dev):
        yield init_device_mesh(dev.type, (1, 1),
                               mesh_dim_names=("data", "model"))


def init_on_ranks(gen: torch.Generator, cfg, mesh, device=None,
                  rules=None) -> dict:
    """``transformer.init(gen, cfg, device)``'s weights placed on
    ``mesh`` by ``rules`` (default its decode rules, as
    ``sharding.place_params`` places them; training passes
    ``sharding.train_rules_of``): every rank draws
    them all, in ``init``'s order, from its own generator seeded alike,
    and keeps its slices of each piece as soon as it is drawn, so it
    holds one layer whole at a time, of a MoE layer one expert stack
    (mixtral-8x7b's 4 layers at published width are about 24 GB of
    float32 weights; four ranks on one card cannot each draw them whole
    first).  On a card the memory a piece's draw took is given back at
    once, and ranks that share a card draw one after the other (a
    barrier between them), so only one rank's draw is in flight (the
    jamba window's expert stacks, 12 GiB each, beside two ranks' 24 GiB
    of slices on one card).  They draw at once where their slices and a
    piece drawn whole each fit in half the card side by side
    (``_draws_crowd``): a rank's first use of the card (≈ 12 s on an
    H100) then overlaps the others'."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as S, spmd
    from repro_torch.models import transformer as M
    rules = rules or S.decode_rules_of(mesh)
    on_card = device is not None and torch.device(device).type == "cuda"

    def place(tree, specs):
        out = S.map_specs(lambda axes, t: t if spmd.is_dtensor(t) else
                          S.place_tree(t, axes, mesh, rules), specs, tree)
        if on_card:
            torch.cuda.empty_cache()
        return out
    sharing = -(-dist.get_world_size() // max(torch.cuda.device_count(), 1))
    if not on_card or sharing == 1 or \
            not _draws_crowd(cfg, mesh, device, sharing):
        return M.init(gen, cfg, device=device, place=place)
    params = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            params = M.init(gen, cfg, device=device, place=place)
        dist.barrier()
    return params


def _draws_crowd(cfg, mesh, device, sharing: int) -> bool:
    """Whether ``sharing`` ranks on one card would crowd it drawing at
    once: each keeps at most the weights over the mesh's last (model)
    dim and draws one piece whole at a time (a layer, of a MoE layer an
    expert stack: ``transformer.init``'s ``place``); more than half the
    card in all draws in turns (the jamba window's 24 GiB of slices and
    12 GiB stacks over (1, 2))."""
    from repro_torch import tree as T
    from repro_torch.models import transformer as M

    def size(t):
        return sum(v.numel() * v.element_size() for v in T.leaves(t))
    params = M.trainable(M.abstract_init(cfg), cfg)
    pieces = []
    for layer in params["layers"]:
        stacks = [v for v in T.leaves(layer) if v.ndim == 3]
        pieces += [size(stacks[:1]), size(layer) - size(stacks)]
    kept = size(params) / mesh.size(mesh.ndim - 1)
    total = torch.cuda.get_device_properties(device).total_memory
    return sharing * (kept + max(pieces)) > total / 2


# the kinds of ``kernels/ops.cached_per_weight`` values that
# ``rank_weight_bytes``' "cached" reckons: MLA's k_up/v_up columns of
# the rank's heads, an SSM layer's whole conv weight, conv bias and norm
# scale
CACHED_KINDS = ("mla_heads", "ssm_whole")


def rank_weight_bytes(cfg, shape, names=("data", "model"),
                      train: bool = False) -> dict:
    """The bytes of the weights one rank of a ``shape`` mesh keeps under
    the decode rules (under the FSDP train rules with ``train``:
    ``sharding.train_rules_of``; then "train" is what a rank keeps
    while it trains, its shards of the params, the AdamW moments m and
    v (float32, as ``optim.optimizer.init`` makes them) and the
    gradients, four times "rank"; the layer gathered whole over the
    data dims at a time and the activations come on top)
    (``place_params``'s placements, as the dry-run
    counts them: ``launch/dryrun.place`` under a fake group), beside
    the whole model's and its largest layer's (what ``init_on_ranks``
    holds whole at a time), from the configuration alone (``meta``
    tensors).  ``cached``: what a rank gathers and caches at first use
    beside its slices: in an MLA layer the columns of the rank's heads
    of k_up and v_up (``mla._up``), and in an SSM layer the whole conv
    weight, conv bias and norm scale (``mamba2._whole``); the LM head
    is used as the rank's vocab slice (``transformer.apply_head``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree as T
    from repro_torch.dist import sharding as S
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as M
    params = M.trainable(M.abstract_init(cfg), cfg)

    def size(t):
        return sum(v.numel() * v.element_size() for v in T.leaves(t))
    with fake_world(math.prod(shape)):
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)
        rules = S.train_rules_of(mesh) if train else S.decode_rules_of(mesh)
        rank, _ = dryrun.place(mesh, M.param_specs(cfg), params, rules)
    up = sum(size(p["attn"][n]) for p in params["layers"]
             if "k_up" in p.get("attn", {}) for n in ("k_up", "v_up"))
    ssm = sum(size([p["attn"][n] for n in ("conv_w", "conv_b", "norm")])
              for p in params["layers"] if "conv_w" in p.get("attn", {}))
    out = {"rank": rank, "whole": size(params),
           "cached": up // shape[-1] + ssm,
           "largest_layer": max(size(p) for p in params["layers"])}
    if train:
        out["train"] = 4 * rank
    return out
