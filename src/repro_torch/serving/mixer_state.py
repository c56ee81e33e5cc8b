"""MixerState: the request-lifecycle protocol of a per-layer cache
layout.

The JAX package runs three layouts through this protocol (paged KV
blocks, sliding-window ring tables, recurrent SSM slots).  This slice
of the port carries the paged layout of full-attention GQA stacks,
``block_cache.BlockKVCache``; ``layer_layouts`` still names every
layer's layout, so a stack that needs another one is refused by name.
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
