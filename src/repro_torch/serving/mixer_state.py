"""MixerState: the request-lifecycle protocol of a per-layer cache
layout, and the recurrent slot layout.

The port runs the JAX package's three layouts through this protocol:
  * paged K/V or MLA latent blocks and (``ring_blocks > 0``) the
    window-sized ring tables of sliding-window stacks, both in
    ``block_cache.BlockKVCache``;
  * per-request recurrent slots (``RecurrentSlotState`` below): SSM
    (mamba2 SSD) layers keep O(1) state per request, one slot of a
    fixed pool holding (hidden state, conv tail); no block table,
    nothing pages.
``layer_layouts`` names every layer's layout.  The slot layout's
snapshot index, swap-to-host and ``copy_slot`` / ``snapshot_slots`` /
``restore_slots`` serve the prefix cache and speculative decoding and
come with them (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

import abc

import numpy as np
import torch

from repro_torch.layers import mamba2
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


class RecurrentSlotState(MixerState):
    """Per-request recurrent slots: the SSM mixer-state layout.

    Pool per layer: (num_slots, ...) SSD hidden state + conv tail.  Slot
    0 is scratch (padded batch rows write there).  A request owns one
    slot for its whole life, whatever its length; a slot is zeroed when
    it is handed out, since its previous owner's state is still in it.
    """

    def __init__(self, cfg, layer_ids: list[int], num_slots: int,
                 dtype=torch.float32, device="cpu"):
        # BlockAllocator's free list with the reserved id 0 and its
        # invariant checks is what a slot pool needs (slots are blocks
        # that are never shared)
        from repro_torch.serving.block_cache import BlockAllocator
        self.cfg = cfg
        self.layer_ids = list(layer_ids)
        self.num_slots = num_slots
        self.allocator = BlockAllocator(num_slots)
        self.pools = [mamba2.init_paged_state(cfg, num_slots, dtype, device)
                      for _ in self.layer_ids]
        self.peak_used = 0

    # ------------------------------------------------------- lifecycle

    def alloc_prompt(self, req) -> bool:
        return self._alloc_slot(req)

    def ensure_capacity(self, req, n_tokens: int) -> bool:
        return self._alloc_slot(req)

    def _alloc_slot(self, req) -> bool:
        """Give req a zeroed slot if it lacks one; False when none is
        free."""
        if req.slot is not None:
            return True
        got = self.allocator.alloc(1)
        if got is None:
            return False
        req.slot = got[0]
        for pool in self.pools:
            for v in pool.values():
                v[req.slot] = 0.0
        self.peak_used = max(self.peak_used, self.allocator.num_used)
        return True

    def release(self, req):
        if req.slot is not None:
            self.allocator.free([req.slot])
            req.slot = None

    # ------------------------------------------------------------ step

    def slot_rows(self, reqs, batch: int) -> np.ndarray:
        """(batch,) slot ids; padded rows point at scratch slot 0."""
        slots = np.zeros(batch, np.int32)
        for i, r in enumerate(reqs):
            slots[i] = 0 if r.slot is None else r.slot
        return slots

    def stats(self) -> dict:
        """The JAX package's keys; the snapshot index is not ported, so
        its keys read 0."""
        cap = self.allocator.capacity
        return {
            "layout": LAYOUT_SLOT,
            "layers": len(self.layer_ids),
            "num_slots": cap,
            "used_slots": self.allocator.num_used,
            "peak_used_slots": self.peak_used,
            "occupancy": self.peak_used / cap if cap else 0.0,
            "swapped_slots": 0,
            "snapshot_slots": 0,
            "cached_snapshots": 0,
            "snapshot_occupancy": 0.0,
        }
