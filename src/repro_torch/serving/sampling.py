"""Per-request sampling parameters and greedy token selection.

``SamplingParams`` travels with every request.  This slice of the port
serves greedy decoding only: ``temperature > 0`` raises until the
sampling slice brings a counter-based generator (ROADMAP.md queue 1,
item 7, "Sampled decoding"), and with it the per-row sampling operands
(the JAX package's ``sampling_rows``).  Greedy is exact argmax, first
index on ties, as ``jnp.argmax``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy.  Defaults reproduce greedy decoding."""
    temperature: float = 0.0      # 0 => greedy argmax (seed ignored)
    top_k: int = 0                # 0 => no top-k filter
    top_p: float = 1.0            # 1.0 => no nucleus filter
    seed: int = 0                 # per-request PRNG stream
    stop: tuple[int, ...] = ()    # stop/eos token ids (early termination)

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if self.temperature > 0:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) is not ported yet "
                "(ROADMAP.md queue 1, item 7)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0: {self.top_k}")
        object.__setattr__(self, "stop", tuple(int(t) for t in self.stop))

    @property
    def stop_set(self) -> frozenset[int]:
        return frozenset(self.stop)


GREEDY = SamplingParams()


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Select one token per row on the logits' device: (B, V) -> (B,)
    int64, greedy (``SamplingParams`` admits no other policy yet)."""
    return torch.argmax(logits, dim=-1)
