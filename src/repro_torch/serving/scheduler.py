"""Continuous-batching scheduler: admission, chunked-prefill/decode
interleaving, and block-pressure preemption.

Each engine step the scheduler emits a StepPlan:
  * admit   — queued requests move to running while a batch row, the
              token budget, and prompt blocks (or a recurrent slot) are
              all available; a request short of either defers as
              ``no_blocks``, as in the JAX package;
  * prefill — ONE running request advances by one prompt chunk (chunk
              size capped so prefill tokens + decode rows stay under
              ``max_batched_tokens`` — decode latency is protected from
              long prompts, the standard chunked-prefill contract);
  * decode  — every running request past its prompt decodes one token.

Ordering and victim selection live in ``serving/policy.py``.  When the
block pool runs dry the policy's victim is preempted by recompute: its
progress is dropped and it re-runs from scratch.

Every action appends a trace event — tests assert continuous batching
(mid-stream admission, concurrent decode) on this trace.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.serving.policy import make_policy
from repro_torch.serving.request import Request, State


@dataclass(frozen=True)
class SchedulerConfig:
    max_batch: int = 8                # concurrent running requests
    max_tokens_in_flight: int = 1 << 30   # KV-footprint admission budget
    max_batched_tokens: int = 256     # per-step compute budget
    prefill_chunk: int = 16
    policy: str = "fcfs"
    preempt_policy: str = "recompute"


@dataclass
class StepPlan:
    admitted: list[Request] = field(default_factory=list)
    prefill: Request | None = None
    prefill_tokens: int = 0
    decode: list[Request] = field(default_factory=list)

    @property
    def has_work(self) -> bool:
        return bool(self.admitted or self.prefill or self.decode)


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, cache):
        # ``cache`` implements the MixerState request-lifecycle calls
        # (BlockKVCache or the MixerStateCache composite) — the
        # scheduler never sees layouts.
        if cfg.preempt_policy == "swap":
            raise NotImplementedError(
                "preempt_policy='swap' (swap-to-host) is not ported "
                "(ROADMAP.md queue 1, item 7)")
        if cfg.preempt_policy != "recompute":
            raise ValueError(f"unknown preempt_policy {cfg.preempt_policy}")
        self.cfg = cfg
        self.cache = cache
        self.policy = make_policy(cfg.policy)
        self.queue: list[Request] = []
        self.running: list[Request] = []
        self.trace: list[dict] = []
        self._order = 0
        self.preempts = 0        # evicted victims

    # ------------------------------------------------------------- events

    def _ev(self, step: int, event: str, rid=None, **extra):
        self.trace.append({"step": step, "event": event, "rid": rid, **extra})

    # ------------------------------------------------------------- submit

    def submit(self, req: Request, step: int):
        req.submit_step = step
        req._order = self._order  # tie-break for policy sorts
        self._order += 1
        self.queue.append(req)
        self._ev(step, "submit", req.rid, prompt_len=req.prompt_len,
                 max_new=req.max_new, priority=req.priority)

    # ----------------------------------------------------------- admission

    def tokens_in_flight(self) -> int:
        return sum(r.total_tokens for r in self.running)

    def _admit(self, step: int, plan: StepPlan):
        for req in self.policy.queue_order(self.queue):
            reason = self.policy.admission_defer(self, req)
            if reason is not None:
                self._ev(step, "defer", req.rid, reason=reason)
                continue
            if len(self.running) >= self.cfg.max_batch:
                self._ev(step, "defer", req.rid, reason="no_slot")
                break
            if (self.tokens_in_flight() + req.total_tokens
                    > self.cfg.max_tokens_in_flight):
                self._ev(step, "defer", req.rid, reason="token_budget")
                break
            if not self.cache.alloc_prompt(req):
                self._ev(step, "defer", req.rid, reason="no_blocks")
                break
            req.state = State.PREFILL
            req.admit_step = step
            self.queue.remove(req)
            self.running.append(req)
            plan.admitted.append(req)
            self._ev(step, "admit", req.rid, running=len(self.running),
                     blocks=len(req.blocks), slot=req.slot)

    # ---------------------------------------------------------- preemption

    def _preempt_one(self, step: int, protect: Request) -> bool:
        """Free blocks by preempting the policy's victim — possibly
        ``protect`` itself.  The victim is the youngest within its
        priority class (requeued with its ORIGINAL seniority), so the
        oldest request always keeps its blocks and two growing requests
        can never evict each other forever."""
        victim = self.policy.victim(self.running)
        self.running.remove(victim)
        self.preempts += 1
        self.cache.release(victim)
        victim.reset_for_requeue()
        self._ev(step, "evict", victim.rid, preemptions=victim.preemptions)
        self.queue.append(victim)
        return victim is not protect

    def grow_or_preempt(self, step: int, req: Request, n_tokens: int) -> bool:
        """Ensure req's blocks cover n_tokens cache slots, preempting
        under pool pressure.  False iff req itself got preempted."""
        while not self.cache.ensure_capacity(req, n_tokens):
            if not self._preempt_one(step, req):
                return False
        return True

    # ------------------------------------------------------------- planning

    def schedule(self, step: int) -> StepPlan:
        plan = StepPlan()
        self._admit(step, plan)
        plan.decode = [r for r in self.running if r.state == State.DECODE]
        prefilling = self.policy.prefill_order(
            [r for r in self.running if r.state == State.PREFILL])
        if prefilling:
            budget = self.cfg.max_batched_tokens - len(plan.decode)
            req = prefilling[0]
            chunk = min(self.cfg.prefill_chunk, req.prompt_len - req.pos,
                        max(budget, 0))
            if chunk > 0:
                plan.prefill = req
                plan.prefill_tokens = chunk
        return plan

    # ----------------------------------------------------------- diagnostics

    def stall_reasons(self) -> dict[int, tuple[str, str]]:
        """rid -> (state, last recorded defer reason) for every queued
        request, so a stalled ``Engine.run()`` can report WHY each
        request cannot make progress."""
        last: dict[int, str] = {}
        for e in self.trace:
            if e["event"] == "defer":
                last[e["rid"]] = e["reason"]
        return {r.rid: (r.state.value, last.get(r.rid, "never_considered"))
                for r in self.queue}

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
