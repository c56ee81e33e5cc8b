"""Scheduling policy: admission ordering, prefill ordering and
preemption-victim selection.

The Scheduler owns the *mechanism* (slot/budget/block checks, trace
events); a policy owns the *decisions*:

  * ``queue_order``    — which queued request is considered first;
  * ``prefill_order``  — which running PREFILL request gets the chunk;
  * ``victim``         — which running request is preempted under block
                         pressure;
  * ``admission_defer``— an extra, policy-specific reason to skip a
                         request this pass (``None`` = admissible).

This slice ports ``fcfs``; the JAX package's ``priority`` and ``slo``
policies come with the serving-breadth slice (ROADMAP.md queue 1,
item 7).
"""
from __future__ import annotations

from repro_torch.serving.request import Request


class FCFSPolicy:
    """Arrival order; victim = lowest-priority then youngest."""

    name = "fcfs"

    def queue_order(self, queue: list[Request]) -> list[Request]:
        return sorted(queue, key=lambda r: r._order)

    def prefill_order(self, prefilling: list[Request]) -> list[Request]:
        return sorted(prefilling, key=lambda r: r._order)

    def victim(self, running: list[Request]) -> Request:
        return sorted(running, key=lambda r: (r.priority, -r._order))[0]

    def admission_defer(self, sched, req: Request) -> str | None:
        return None


POLICIES = {"fcfs": FCFSPolicy}


def make_policy(name: str) -> FCFSPolicy:
    if name in ("priority", "slo"):
        raise NotImplementedError(
            f"scheduling policy {name!r} is not ported "
            "(ROADMAP.md queue 1, item 7)")
    if name not in POLICIES:
        raise ValueError(
            f"unknown policy {name!r} (want one of {sorted(POLICIES)})")
    return POLICIES[name]()
