"""Devices of the data-axis serving shards.

The counterpart of the JAX package's ``repro.dist.sharding.shard_meshes``
(its logical-axis rules and meshes are ROADMAP.md queue 1, item 10, and
not ported): each shard of a ``ShardedEngine`` gets one device.  A shard
is an isolation domain first (its own ``Engine``: pools, block tables,
prefix and snapshot indexes) and hardware second, so with fewer devices
than shards the list is tiled and several shards share a device, as in
the JAX package's single-device tests."""
from __future__ import annotations

import torch


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
