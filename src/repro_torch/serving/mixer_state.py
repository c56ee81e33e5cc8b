"""MixerState: the request-lifecycle protocol of a per-layer cache
layout.

The JAX package runs three layouts through this protocol (paged KV
blocks, sliding-window ring tables, recurrent SSM slots).  The port
carries the two block layouts, both in ``block_cache.BlockKVCache``:
paged K/V or MLA latent blocks, and (``ring_blocks > 0``) the
window-sized ring tables of sliding-window stacks.  ``layer_layouts``
still names every layer's layout, so a stack that needs recurrent slots
is refused by name.
"""
from __future__ import annotations

import abc

from repro_torch.models.transformer import layer_plan

LAYOUT_PAGED = "paged"     # unbounded block table (full attention)
LAYOUT_RING = "ring"       # window-sized circular block table
LAYOUT_SLOT = "slot"       # per-request recurrent state slot


def layer_layouts(cfg) -> list[str]:
    """One mixer-state layout per layer (plan order)."""
    out = []
    for mix, _f in layer_plan(cfg):
        if mix == "ssm":
            out.append(LAYOUT_SLOT)
        elif cfg.sliding_window:
            out.append(LAYOUT_RING)
        else:
            out.append(LAYOUT_PAGED)
    return out


def ring_block_count(window: int, block_size: int,
                     prefill_chunk: int) -> int:
    """Blocks a sliding-window ring table needs.

    The ring must still hold every key a query can attend AFTER a full
    prefill chunk lands: the first chunk query at position L needs keys
    back to L - window + 1 while the newest write sits at
    L + chunk - 1, so capacity >= window + chunk - 1 tokens.
    """
    return -(-(window + max(prefill_chunk, 1) - 1) // block_size)


class MixerState(abc.ABC):
    """Request-lifecycle protocol every mixer-state layout implements.

    A layout owns the device pools for ITS layers plus whatever
    bookkeeping maps a request onto them (block lists).  The
    scheduler/engine drive requests exclusively through these calls;
    "no capacity" is always reported by returning False so the caller
    can preempt, never by raising.
    """

    @abc.abstractmethod
    def alloc_prompt(self, req) -> bool:
        """Admission-time allocation for req's prompt (all-or-nothing)."""

    @abc.abstractmethod
    def ensure_capacity(self, req, n_tokens: int) -> bool:
        """Grow req's state to cover n_tokens; False under pressure."""

    @abc.abstractmethod
    def release(self, req):
        """Drop req's references; state becomes reclaimable."""
