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
counterpart of a one-device mesh.  A process group is global state, so
each of these is a context manager that destroys the group it made.
"""
from __future__ import annotations

import contextlib
import math

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
