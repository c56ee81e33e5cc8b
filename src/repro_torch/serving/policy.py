"""Pluggable scheduling policies: admission ordering, prefill ordering,
preemption-victim selection, and policy-specific admission gates.

The Scheduler owns the *mechanism* (slot/budget/block checks, swap-in,
trace events); a ``SchedulingPolicy`` owns the *decisions*:

  * ``queue_order``    — which queued request is considered first;
  * ``prefill_order``  — which running PREFILL request gets the chunk;
  * ``victim``         — which running request is preempted under block
                         pressure;
  * ``admission_defer``— an extra, policy-specific reason to skip a
                         request this pass (``None`` = admissible).
                         Skips are per-request (``continue`` semantics),
                         so one gated request never head-of-line-blocks
                         the rest of the queue.

``fcfs`` takes arrival order, ``priority`` higher priority first.

``slo`` adds multi-tenant service classes on top of the same mechanism:

  * every request carries a ``tenant`` and an slo class, ``latency`` or
    ``throughput`` (defaulted from the tenant spec);
  * latency-class requests are admitted and prefilled first and their
    decode rows are preempted last (decode-protection);
  * throughput-class requests absorb preemption (youngest throughput
    row is always the first victim) and backfill leftover capacity;
  * a tenant's in-flight token footprint is capped by its
    ``token_budget`` — an over-budget tenant defers with reason
    ``tenant_budget`` while other tenants keep admitting behind it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from repro_torch.serving.request import Request, State

LATENCY = "latency"
THROUGHPUT = "throughput"
SLO_CLASSES = (LATENCY, THROUGHPUT)


@dataclass(frozen=True)
class TenantSpec:
    """Per-tenant SLO contract: default class + in-flight token budget
    (0 = unbounded).  The budget counts ``total_tokens`` (prompt +
    max_new — the KV footprint a request may grow to) over the tenant's
    running requests, same accounting as ``max_tokens_in_flight``."""
    name: str
    slo_class: str = LATENCY
    token_budget: int = 0

    def __post_init__(self):
        if self.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: unknown slo class "
                f"{self.slo_class!r} (want one of {SLO_CLASSES})")
        if self.token_budget < 0:
            raise ValueError(f"tenant {self.name!r}: negative token_budget")


def parse_tenants(spec) -> dict[str, TenantSpec]:
    """Parse a tenant spec into ``{name: TenantSpec}``.

    Accepts the canonical string form ``"a=latency:2048,b=throughput"``
    (budget optional, 0 = unbounded — also what a frozen
    SchedulerConfig stores), an iterable of ``(name, slo_class,
    budget)`` triples, or a ready ``{name: TenantSpec}`` dict.
    """
    if not spec:
        return {}
    if isinstance(spec, dict):
        return dict(spec)
    if isinstance(spec, str):
        out = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, rhs = part.partition("=")
            klass, _, budget = rhs.partition(":")
            out[name.strip()] = TenantSpec(
                name.strip(), klass.strip() or LATENCY,
                int(budget) if budget.strip() else 0)
        return out
    return {name: TenantSpec(name, klass, int(budget))
            for name, klass, budget in spec}


def tenants_arg(spec) -> str:
    """Normalize any tenant spec to the canonical string form a frozen
    SchedulerConfig/EngineConfig stores — hashable AND stable through a
    JSON round-trip (the trace meta record embeds the config)."""
    return ",".join(f"{t.name}={t.slo_class}:{t.token_budget}"
                    for t in parse_tenants(spec).values())


@runtime_checkable
class SchedulingPolicy(Protocol):
    name: str

    def queue_order(self, queue: list[Request]) -> list[Request]: ...

    def prefill_order(self, prefilling: list[Request]) -> list[Request]: ...

    def victim(self, running: list[Request]) -> Request: ...

    def admission_defer(self, sched, req: Request) -> str | None: ...

    def slo_class(self, req: Request) -> str: ...


class FCFSPolicy:
    """Arrival order; victim = lowest-priority then youngest."""

    name = "fcfs"

    def queue_order(self, queue):
        return sorted(queue, key=lambda r: r._order)

    def prefill_order(self, prefilling):
        return sorted(prefilling, key=lambda r: r._order)

    def victim(self, running):
        return sorted(running, key=lambda r: (r.priority, -r._order))[0]

    def admission_defer(self, sched, req):
        return None

    def slo_class(self, req):
        return req.slo_class or LATENCY


class PriorityPolicy(FCFSPolicy):
    """Higher ``priority`` first, FCFS within a class."""

    name = "priority"

    def queue_order(self, queue):
        return sorted(queue, key=lambda r: (-r.priority, r._order))

    def prefill_order(self, prefilling):
        return sorted(prefilling, key=lambda r: (-r.priority, r._order))


class SLOPolicy(FCFSPolicy):
    """Multi-tenant latency/throughput classes with per-tenant budgets.

    Ordering keys (all FCFS within an equivalence class):
      * queue/prefill: latency class first, then priority, then arrival;
      * victim: throughput class first; within the latency class,
        PREFILL-state rows before DECODE-state rows (decode-protection:
        a latency request that already reached decode is preempted
        last), then lowest priority, then youngest.
    """

    name = "slo"

    def __init__(self, tenants=None):
        self.tenants = parse_tenants(tenants)

    def spec(self, tenant: str) -> TenantSpec:
        return self.tenants.get(tenant) or TenantSpec(tenant)

    def slo_class(self, req):
        return req.slo_class or self.spec(req.tenant).slo_class

    def queue_order(self, queue):
        return sorted(queue, key=lambda r: (
            0 if self.slo_class(r) == LATENCY else 1, -r.priority, r._order))

    def prefill_order(self, prefilling):
        return self.queue_order(prefilling)

    def victim(self, running):
        return sorted(running, key=lambda r: (
            0 if self.slo_class(r) == THROUGHPUT else 1,
            1 if r.state == State.DECODE else 0,
            r.priority, -r._order))[0]

    def admission_defer(self, sched, req):
        budget = self.spec(req.tenant).token_budget
        if budget and (sched.tenant_tokens_in_flight(req.tenant)
                       + req.total_tokens > budget):
            return "tenant_budget"
        return None


POLICIES = {"fcfs": FCFSPolicy, "priority": PriorityPolicy, "slo": SLOPolicy}


def make_policy(name: str, *, tenants=None) -> SchedulingPolicy:
    if name not in POLICIES:
        raise ValueError(
            f"unknown policy {name!r} (want one of {sorted(POLICIES)})")
    return SLOPolicy(tenants) if name == "slo" else POLICIES[name]()
