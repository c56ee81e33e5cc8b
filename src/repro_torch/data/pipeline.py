"""Deterministic, shardable synthetic data pipeline: the port's copy of
the JAX package's ``repro.data.pipeline`` (numpy only, the same seeds,
so both packages give the same batches bit for bit).

Production posture: each data-parallel host generates ONLY its shard of
every global batch, derived from (seed, step, shard_index) — no host
ever materializes the global batch, there is no coordination, and a
restart at step k regenerates exactly the same stream (checkpoint
resume reproducibility is property-tested).

The synthetic LM stream is a stationary order-1 Markov chain over the
vocabulary with a fixed random transition structure: next-token entropy
is strictly below uniform, so a learning model's loss must drop below
log(V) — used by the end-to-end example as a functional signal.
``to_tensors`` hands a batch to the port on a device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8   # Markov successors per token (entropy:
                         # log(branching))


class SyntheticLM:
    """Per-shard deterministic Markov LM stream."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        rng = np.random.default_rng(cfg.seed)  # shared structure
        self.successors = rng.integers(
            0, cfg.vocab, (cfg.vocab, cfg.branching), dtype=np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """The shard's slice of global batch ``step``: tokens + labels."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + self.shard_index)
        b, t = self.local_batch, cfg.seq_len
        toks = np.empty((b, t + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        choices = rng.integers(0, cfg.branching, (b, t))
        for i in range(t):
            toks[:, i + 1] = self.successors[toks[:, i], choices[:, i]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch_for_test(self, step: int) -> dict[str, np.ndarray]:
        """Assemble the global batch from all shards (tests only)."""
        shards = [SyntheticLM(self.cfg, i, self.num_shards).batch(step)
                  for i in range(self.num_shards)]
        return {k: np.concatenate([s[k] for s in shards], axis=0)
                for k in shards[0]}


def to_tensors(batch: dict[str, np.ndarray],
               device) -> dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long().to(device)
            for k, v in batch.items()}
