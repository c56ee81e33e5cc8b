"""Request lifecycle for the continuous-batching engine.

A request moves QUEUED -> PREFILL -> DECODE -> FINISHED.  Under
block-pool pressure the scheduler preempts by RECOMPUTE: blocks (or its
recurrent slot) are dropped and the request returns to QUEUED with its
progress discarded (the JAX package's swap-to-host path is not ported
yet).
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
    FINISHED = "finished"
    CANCELLED = "cancelled"            # terminal: caller dropped the request


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new: int
    priority: int = 0                  # higher = scheduled first
    sampling: SamplingParams = GREEDY  # decode policy (greedy default)

    # runtime (owned by the scheduler/engine)
    state: State = State.QUEUED
    pos: int = 0                       # tokens written to the mixer state
    out: list[int] = field(default_factory=list)
    blocks: list[int] = field(default_factory=list)   # block-family layers
    slot: int | None = None            # recurrent-slot-family layers
    virtual_blocks: int = 0            # logical high-water (ring reuse stat)
    preemptions: int = 0
    streamed: int = 0                  # commit-callback delivery watermark
                                       # into ``out``; survives recompute
                                       # preemption (the regenerated
                                       # tokens are identical, so they are
                                       # not re-delivered)
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
        self.blocks = []
        self.slot = None
        self.virtual_blocks = 0
        self.preemptions += 1

    def full_sequence(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.out, np.int32)])
