"""Fault tolerance planning: heartbeat monitoring and elastic re-mesh.

Runbook on device/host failure (training, in the JAX package):
  1. HeartbeatMonitor flags dead hosts (missed beats) and stragglers
     (step time >> fleet median) — both are drained.
  2. plan_remesh picks the largest valid submesh over the survivors
     that keeps the model-parallel degree intact and divides the
     original data-parallel degree, so the global batch is preserved by
     scaling gradient-accumulation microbatches.
  3. the surviving devices are re-meshed, the program rebuilt, the
     latest checkpoint restored.

The port's copy of the JAX package's ``repro.dist.fault`` (pure
Python; tests/test_torch_roles.py compares the two over a grid of
inputs).  Serving uses the heartbeat monitor: ``ShardedEngine.reap``
kills the shards it declares dead.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass


class HeartbeatMonitor:
    """Tracks per-host liveness and step-time stragglers.

    ``set_groups`` partitions hosts into comparison classes (e.g. the
    serving layer's prefill vs decode worker roles): straggler medians
    are computed WITHIN a group, because a prefill shard's chunk-sized
    steps are legitimately slower than decode steps — a role-blind
    fleet median would drain every prefill worker as a straggler."""

    def __init__(self, n_hosts: int, dead_after: float,
                 straggler_factor: float = 2.0):
        self.n_hosts = n_hosts
        self.dead_after = dead_after
        self.straggler_factor = straggler_factor
        self._last_beat: dict[int, float] = {}
        self._step_time: dict[int, float] = {}
        self._group_of: dict[int, str] = {}

    def set_groups(self, group_of: dict[int, str]):
        """host -> comparison-class label (unlisted hosts share one
        implicit default group)."""
        self._group_of = dict(group_of)

    def beat(self, host: int, now: float, step_time: float | None = None):
        self._last_beat[host] = now
        if step_time is not None:
            self._step_time[host] = step_time

    def stragglers(self) -> list[int]:
        if not self._step_time:
            return []
        by_group: dict[str, list[float]] = {}
        for h, t in self._step_time.items():
            by_group.setdefault(self._group_of.get(h, ""), []).append(t)
        med = {g: statistics.median(ts) for g, ts in by_group.items()}
        return sorted(
            h for h, t in self._step_time.items()
            if t > self.straggler_factor * med[self._group_of.get(h, "")])

    def dead_hosts(self, now: float) -> list[int]:
        dead = [h for h in range(self.n_hosts)
                if now - self._last_beat.get(h, float("-inf")) > self.dead_after]
        return sorted(dead)

    def to_drain(self, now: float) -> list[int]:
        return sorted(set(self.stragglers()) | set(self.dead_hosts(now)))


@dataclass(frozen=True)
class RemeshPlan:
    pod: int
    data: int
    model: int
    microbatch_scale: int

    @property
    def devices_used(self) -> int:
        return self.pod * self.data * self.model


def plan_remesh(n_survivors: int, *, model_parallel: int = 16,
                full_data: int = 16, full_pod: int = 2) -> RemeshPlan:
    """Largest submesh over survivors preserving the global batch.

    Keeps model_parallel fixed (param layout unchanged) and picks the
    largest (pod, data) with pod*data dividing the original
    data-parallel degree; the lost degree is made up by scaling
    microbatches (gradient accumulation), so the global batch —
    and therefore the training trajectory — is preserved.
    """
    full_dp = full_pod * full_data
    best: RemeshPlan | None = None
    for pod in range(1, full_pod + 1):
        for data in range(1, full_data + 1):
            dp = pod * data
            if full_dp % dp != 0:
                continue
            if pod * data * model_parallel > n_survivors:
                continue
            plan = RemeshPlan(pod, data, model_parallel, full_dp // dp)
            if best is None or plan.devices_used > best.devices_used:
                best = plan
    if best is None:
        raise ValueError(
            f"{n_survivors} survivors cannot host model_parallel="
            f"{model_parallel}")
    return best
