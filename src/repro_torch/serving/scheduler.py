"""Continuous-batching scheduler: admission, chunked-prefill/decode
interleaving, and block-pressure preemption.

Each engine step the scheduler emits a StepPlan:
  * admit   — queued requests move to running while a batch row, the
              token budget, and prompt blocks (or a recurrent slot) are
              all available; a request short of either defers as
              ``no_blocks``, as in the JAX package.  A fresh request's
              prompt is first matched against the prefix index
              (``cache.alloc_prompt``): cached blocks are adopted and
              prefill starts past them.  A SWAPPED request is restored
              from its host copies (``cache.swap_in``) and resumes
              exactly where it was preempted;
  * prefill — ONE running request advances by one prompt chunk (chunk
              size capped so prefill tokens + decode rows stay under
              ``max_batched_tokens`` — decode latency is protected from
              long prompts, the standard chunked-prefill contract);
  * decode  — every running request past its prompt decodes one token
              (or verifies a speculative draft: ``decode_cost`` tokens a
              row are charged against the prefill budget).

Ordering, victim selection, and policy-specific admission gates live in
``serving/policy.py`` (``SchedulingPolicy``): "fcfs" (arrival order),
"priority" (higher first, FCFS within a class), or "slo" (multi-tenant
latency/throughput classes with per-tenant token budgets).  When the
block pool runs dry the policy's victim is preempted; ``preempt_policy``
picks how: "swap" parks its KV on the host and resumes it later,
"recompute" drops its progress and re-runs it from scratch.

Every action appends a trace event — tests assert continuous batching
(mid-stream admission, concurrent decode) on this trace.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.serving import roles as R
from repro_torch.serving.policy import make_policy
from repro_torch.serving.request import Request, State
from repro_torch.serving.tracing import Tracer


@dataclass(frozen=True)
class SchedulerConfig:
    max_batch: int = 8                # concurrent running requests
    max_tokens_in_flight: int = 1 << 30   # KV-footprint admission budget
    max_batched_tokens: int = 256     # per-step compute budget
    prefill_chunk: int = 16
    policy: str = "fcfs"              # fcfs | priority | slo
    preempt_policy: str = "swap"      # swap | recompute
    decode_cost: int = 1              # compute tokens one decode row may
                                      # burn a step (spec_k + 1 when the
                                      # engine verifies drafts)
    tenants: str = ""                 # slo-policy tenant spec in the
                                      # canonical "name=class:budget,..."
                                      # form (policy.tenants_arg)


@dataclass
class StepPlan:
    admitted: list[Request] = field(default_factory=list)
    prefill: Request | None = None
    prefill_tokens: int = 0
    decode: list[Request] = field(default_factory=list)
    transfer_waits: int = 0   # queued requests still streaming in over
                              # the modelled link: the deadline counts
                              # this shard's steps, so a step with only
                              # these is still progress

    @property
    def has_work(self) -> bool:
        return bool(self.admitted or self.prefill or self.decode
                    or self.transfer_waits)


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, cache,
                 tracer: Tracer | None = None, role: R.Role = R.MIXED):
        # ``cache`` implements the MixerState request-lifecycle calls
        # (BlockKVCache or the MixerStateCache composite) — the
        # scheduler never sees layouts.
        if cfg.preempt_policy not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt_policy {cfg.preempt_policy}")
        self.cfg = cfg
        self.cache = cache
        self.role = role
        self.policy = make_policy(cfg.policy, tenants=cfg.tenants)
        self.tracer = tracer if tracer is not None else Tracer()
        self.queue: list[Request] = []
        self.running: list[Request] = []
        self.trace: list[dict] = []
        self._order = 0
        self.preempts = 0        # evict + swap_out victims
        self.swap_losts = 0      # parked content evicted while swapped
        # live copy of cfg.decode_cost: the engine lowers it when a
        # replay cost curve caps the speculative verify chunk below the
        # configured spec_k (Engine.apply_replay_curve)
        self.decode_cost = cfg.decode_cost

    # ------------------------------------------------------------- events

    def _ev(self, step: int, event: str, rid=None, **extra):
        self.trace.append({"step": step, "event": event, "rid": rid, **extra})
        # per-request lifecycle timeline: the same events stream into
        # the structured trace (step-level decode/spec_decode summaries
        # are covered by the engine's own step records)
        if rid is not None and self.tracer.enabled:
            self.tracer.request(step, event, rid, **extra)

    # ------------------------------------------------------------- submit

    def submit(self, req: Request, step: int):
        req.submit_step = step
        req._order = self._order  # tie-break for policy sorts
        self._order += 1
        if not req.slo_class:
            # defaulted from the tenant spec so traces, stats, and the
            # slo victim sort all see the resolved class
            req.slo_class = self.policy.slo_class(req)
        self.queue.append(req)
        self._ev(step, "submit", req.rid, prompt_len=req.prompt_len,
                 max_new=req.max_new, priority=req.priority,
                 tenant=req.tenant, slo_class=req.slo_class)

    def adopt(self, req: Request, step: int, lost: bool = False):
        """Take over a request migrated from a peer shard.  It arrives
        QUEUED or SWAPPED (already serialized by the source's
        ``swap_out``), keeps its rid, sampling state and committed
        output, and gets a fresh local ``_order``.  ``lost=True``: it
        was rescued from a dead shard whose device state is gone, reset
        for recompute, and the loss shows as a host-swap chain eviction
        does (a ``swap_lost`` event and count, read by
        ``stall_reasons``)."""
        req._order = self._order
        self._order += 1
        self.queue.append(req)
        self._ev(step, "migrate_in", req.rid, pos=req.pos,
                 state=req.state.value, preemptions=req.preemptions)
        if lost:
            self.swap_losts += 1
            self._ev(step, "swap_lost", req.rid,
                     preemptions=req.preemptions, reason="shard_lost")

    def _queue_order(self) -> list[Request]:
        return self.policy.queue_order(self.queue)

    # ----------------------------------------------------------- admission

    def tokens_in_flight(self) -> int:
        return sum(r.total_tokens for r in self.running)

    def tenant_tokens_in_flight(self, tenant: str) -> int:
        return sum(r.total_tokens for r in self.running
                   if r.tenant == tenant)

    def _admit(self, step: int, plan: StepPlan):
        for req in self._queue_order():
            if R.transfer_pending(req, step):
                # the modelled prefill->decode link is still streaming
                # this request in: it alone waits, the requests behind
                # it stay admissible
                plan.transfer_waits += 1
                self._ev(step, "defer", req.rid, reason="transfer_pending",
                         until_step=req.transfer_until_step)
                continue
            reason = self.policy.admission_defer(self, req)
            if reason is not None:
                # policy gate (e.g. a tenant over its token budget):
                # per-request, as transfer_pending — tenants behind the
                # gated one keep admitting
                self._ev(step, "defer", req.rid, reason=reason)
                continue
            if len(self.running) >= self.cfg.max_batch:
                self._ev(step, "defer", req.rid, reason="no_slot")
                break
            if (self.tokens_in_flight() + req.total_tokens
                    > self.cfg.max_tokens_in_flight):
                self._ev(step, "defer", req.rid, reason="token_budget")
                break
            if req.state == State.SWAPPED:
                ok = self.cache.swap_in(req)
                if ok is None:
                    # a re-adoptable block's hash chain was evicted
                    # while the request was parked: the content is
                    # gone, fall back to recompute-from-scratch (the
                    # request stays in this admission pass as QUEUED)
                    req.reset_for_requeue()
                    self.swap_losts += 1
                    self._ev(step, "swap_lost", req.rid,
                             preemptions=req.preemptions)
                elif not ok:
                    self._ev(step, "defer", req.rid, reason="no_blocks")
                    break
                else:
                    req.state = (State.DECODE if req.pos >= req.prompt_len
                                 else State.PREFILL)
                    self.queue.remove(req)
                    self.running.append(req)
                    plan.admitted.append(req)
                    self._ev(step, "swap_in", req.rid, pos=req.pos,
                             blocks=len(req.blocks))
                    continue
            if not self.cache.alloc_prompt(req):
                self._ev(step, "defer", req.rid, reason="no_blocks")
                break
            req.state = State.PREFILL
            req.admit_step = step
            self.queue.remove(req)
            self.running.append(req)
            plan.admitted.append(req)
            self._ev(step, "admit", req.rid, running=len(self.running),
                     blocks=len(req.blocks),
                     cached_tokens=req.skipped_prefill, slot=req.slot)

    # ---------------------------------------------------------- preemption

    def _preempt_one(self, step: int, protect: Request) -> bool:
        """Free blocks by preempting the policy's victim — possibly
        ``protect`` itself.  All policies prefer the youngest within an
        equivalence class (requeued with its ORIGINAL seniority), so the
        oldest request always keeps its blocks and two growing requests
        can never evict each other forever."""
        victim = self.policy.victim(self.running)
        self.running.remove(victim)
        self.preempts += 1
        # a request with no computed KV has nothing worth swapping
        if self.cfg.preempt_policy == "swap" and victim.pos > 0:
            self.cache.swap_out(victim)
            victim.park_swapped()
            self._ev(step, "swap_out", victim.rid, pos=victim.pos,
                     preemptions=victim.preemptions)
        else:
            self.cache.release(victim)
            victim.reset_for_requeue()
            self._ev(step, "evict", victim.rid,
                     preemptions=victim.preemptions)
        self.queue.append(victim)
        return victim is not protect

    def grow_or_preempt(self, step: int, req: Request, n_tokens: int) -> bool:
        """Ensure req's blocks cover n_tokens cache slots, preempting
        under pool pressure.  False iff req itself got preempted."""
        while not self.cache.ensure_capacity(req, n_tokens):
            if not self._preempt_one(step, req):
                return False
        return True

    def make_writable(self, step: int, req: Request, idx: int) -> bool:
        """Copy-on-write req's idx-th block if shared, preempting for
        the copy's block under pressure.  False iff req was preempted."""
        while not self.cache.make_writable(req, idx):
            if not self._preempt_one(step, req):
                return False
        return True

    # ------------------------------------------------------------- planning

    def schedule(self, step: int) -> StepPlan:
        plan = StepPlan()
        self._admit(step, plan)
        # a prefill worker never decodes: its DECODE-state requests are
        # parked for handoff (the ShardedEngine drains them right after
        # the step) and must not take the prefill token budget
        plan.decode = ([r for r in self.running if r.state == State.DECODE]
                       if self.role.runs_decode else [])
        prefilling = self.policy.prefill_order(
            [r for r in self.running if r.state == State.PREFILL])
        if prefilling:
            # each decode row may burn decode_cost compute tokens this
            # step (a speculative verify feeds spec_k + 1 a row, not 1)
            budget = self.cfg.max_batched_tokens \
                - len(plan.decode) * self.decode_cost
            req = prefilling[0]
            chunk = min(self.cfg.prefill_chunk, req.prompt_len - req.pos,
                        max(budget, 0))
            if chunk > 0:
                plan.prefill = req
                plan.prefill_tokens = chunk
        return plan

    # ----------------------------------------------------------- diagnostics

    def stall_reasons(self) -> dict[int, tuple[str, str]]:
        """rid -> (state, last recorded stall reason) for every queued
        or swapped request — the latest ``defer`` reason (no_slot /
        token_budget / no_blocks / tenant_budget / transfer_pending) or
        ``swap_lost`` event — so a stalled ``Engine.run()`` can report
        WHY each request cannot make progress.  On a prefill worker,
        DECODE-state requests parked for export read
        ``awaiting_handoff``."""
        last: dict[int, str] = {}
        for e in self.trace:
            if e["event"] == "defer":
                last[e["rid"]] = e["reason"]
            elif e["event"] == "swap_lost":
                last[e["rid"]] = "swap_lost"
        out = {r.rid: (r.state.value, last.get(r.rid, "never_considered"))
               for r in self.queue}
        if not self.role.runs_decode:
            out.update({r.rid: (r.state.value, "awaiting_handoff")
                        for r in self.running if r.state == State.DECODE})
        return out

    def tenant_report(self) -> dict[str, dict]:
        """Per-tenant live accounting: queued/running counts, in-flight
        token footprint vs budget, slo class mix, and the last stall
        reason any of the tenant's requests hit (from the same trace
        scan as ``stall_reasons`` — ``tenant_budget`` is how an
        over-budget tenant shows up)."""
        stalls = {r: reason for r, (_, reason) in self.stall_reasons().items()}
        out: dict[str, dict] = {}
        for r in self.queue + self.running:
            t = out.setdefault(r.tenant, {
                "queued": 0, "running": 0, "tokens_in_flight": 0,
                "token_budget": 0, "classes": {}, "stall": None})
            if r in self.running:
                t["running"] += 1
                t["tokens_in_flight"] += r.total_tokens
            else:
                t["queued"] += 1
                if r.rid in stalls:
                    t["stall"] = stalls[r.rid]
            klass = r.slo_class or self.policy.slo_class(r)
            t["classes"][klass] = t["classes"].get(klass, 0) + 1
        spec = getattr(self.policy, "spec", None)
        if spec is not None:
            for name, t in out.items():
                t["token_budget"] = spec(name).token_budget
        return out

    # ------------------------------------------------------------- lifecycle

    def finish(self, step: int, req: Request):
        self.running.remove(req)
        self.cache.release(req)
        req.state = State.FINISHED
        req.finish_step = step
        self._ev(step, "finish", req.rid, generated=len(req.out),
                 preemptions=req.preemptions)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running
