"""Request lifecycle for the continuous-batching engine.

A request moves QUEUED -> PREFILL -> DECODE -> FINISHED.  Preemption
(block-pool pressure) takes one of two paths, chosen by the scheduler's
``preempt_policy``:

  * ``swap``      — KV blocks are copied to host buffers and the
                    request parks as SWAPPED with its progress intact;
                    re-admission restores the blocks and resumes where
                    it left off (a recurrent slot takes the same trip,
                    or is re-adopted from the snapshot index when the
                    request was parked at a registered snapshot);
  * ``recompute`` — blocks (or the recurrent slot) are dropped and the
                    request returns to QUEUED with its progress
                    discarded.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.sampling import GREEDY, SamplingParams


class State(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    SWAPPED = "swapped"                # preempted, KV parked on the host
    FINISHED = "finished"
    CANCELLED = "cancelled"            # terminal: caller dropped the request


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new: int
    priority: int = 0                  # higher = scheduled first
    arrival_s: float = 0.0             # bench-relative arrival time
    sampling: SamplingParams = GREEDY  # decode policy (greedy default)
    tenant: str = "default"            # slo-policy accounting group
    slo_class: str = ""                # latency | throughput ("" = take
                                       # the tenant spec's default;
                                       # resolved at submit)
    score: bool = False                # teacher-forced logprob scoring:
                                       # chunked prefill only, no decode

    # scoring output: one log p(prompt[i+1] | prompt[:i+1]) per scored
    # position, filled during prefill when ``score`` is set
    logprobs: list[float] = field(default_factory=list)

    # runtime (owned by the scheduler/engine)
    state: State = State.QUEUED
    pos: int = 0                       # tokens written to the mixer state
    out: list[int] = field(default_factory=list)
    blocks: list[int] = field(default_factory=list)   # block-family layers
    slot: int | None = None            # recurrent-slot-family layers
    preemptions: int = 0
    streamed: int = 0                  # commit-callback delivery watermark
                                       # into ``out``; survives recompute
                                       # preemption (the regenerated
                                       # tokens are identical, so they are
                                       # not re-delivered)
    # prefix-cache bookkeeping (owned by BlockKVCache)
    skipped_prefill: int = 0           # prompt tokens adopted from the index
    n_registered: int = 0              # full prompt blocks published
    prefix_key: str = ""               # hash-chain key of the last one
    virtual_blocks: int = 0            # logical high-water (ring reuse stat)
    # swap-to-host: per-layer host copies of owned blocks (block family)
    host_kv: list | None = None
    swap_readopt: int = 0              # leading blocks to re-adopt by hash
    # swap-to-host: per-layer copies of the recurrent slot (slot family)
    host_state: list | None = None
    # slot-snapshot prefix bookkeeping (owned by RecurrentSlotState)
    snap_registered: int = 0           # deepest published snapshot (blocks)
    snap_key: str = ""                 # hash-chain key at that depth
    snap_readopt: bool = False         # parked state == a registered
                                       # snapshot: swap_in re-adopts by hash
    # prefill->decode handoff (serving/sharded.py, serving/roles.py):
    # the modelled link streams this request's state for transfer_steps
    # of the destination's steps; its scheduler defers admission
    # (reason transfer_pending) until step transfer_until_step
    transfer_steps: int = 0
    transfer_until_step: int | None = None
    # step/time marks for latency accounting
    submit_step: int | None = None
    admit_step: int | None = None
    first_token_step: int | None = None
    finish_step: int | None = None
    submit_s: float | None = None
    first_token_s: float | None = None
    finish_s: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def last_token(self) -> int:
        """Token to feed the next decode step."""
        return int(self.out[-1]) if self.out else int(self.prompt[-1])

    @property
    def stopped(self) -> bool:
        """A per-request stop/eos token was emitted."""
        return bool(self.out) and self.out[-1] in self.sampling.stop_set

    @property
    def done(self) -> bool:
        """Length bound reached OR a stop token emitted — the engine
        finishes (and releases blocks) at the step the stop lands."""
        return len(self.out) >= self.max_new or self.stopped

    @property
    def total_tokens(self) -> int:
        """KV footprint if run to completion (admission budget)."""
        return self.prompt_len + self.max_new

    def reset_for_requeue(self):
        """Recompute preemption discards cache + progress."""
        self.state = State.QUEUED
        self.pos = 0
        self.out.clear()
        self.logprobs.clear()
        self.blocks = []
        self.slot = None
        self.host_kv = None
        self.host_state = None
        self.swap_readopt = 0
        self.skipped_prefill = 0
        self.n_registered = 0
        self.prefix_key = ""
        self.snap_registered = 0
        self.snap_key = ""
        self.snap_readopt = False
        self.virtual_blocks = 0
        self.transfer_steps = 0
        self.transfer_until_step = None
        self.preemptions += 1

    def park_swapped(self):
        """Swap preemption keeps progress; blocks were moved to
        ``host_kv`` (a slot to ``host_state``, or marked for re-adoption)
        by the cache's swap_out before this is called."""
        self.state = State.SWAPPED
        self.preemptions += 1

    def full_sequence(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.out, np.int32)])

    def score_ppl(self) -> float:
        """Teacher-forced perplexity over the scored prompt positions
        (scoring requests only; NaN before any chunk lands)."""
        if not self.logprobs:
            return float("nan")
        return float(np.exp(-np.mean(self.logprobs)))
