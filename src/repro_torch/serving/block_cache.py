"""Block-paged KV state: refcounted free-list allocator, the per-layer
device pools, and block-table assembly.

``BlockKVCache`` is the block-family ``MixerState``: the device pools
hold one (num_blocks, block_size, Hkv, Dh) K and V buffer per GQA layer,
or one (num_blocks, block_size, R) c_kv and (num_blocks, block_size,
Dr) k_rope latent buffer per MLA layer; this class owns the host-side
bookkeeping — which physical blocks belong to which sequence, and the
padded (B, max_blocks) block tables the step functions consume.  With
``ring_blocks > 0`` the tables are sliding-window rings: a sequence
never owns more than ``ring_blocks`` blocks, growth past them recycles
the trailing block in place (``ring_reuses``), and the table is exactly
``min(ceil(max_model_len / block_size), ring_blocks)`` wide — the step
functions take the ring's capacity from that width.

Every used block carries a refcount, as in the JAX package, where
prefix sharing gives a block several owners; the port runs without the
prefix index, swap-to-host and copy-on-write (ROADMAP.md queue 1, item
7), so every block here has exactly one owner.

Block 0 is reserved as a scratch block (padded rows and masked writes
are redirected there), so the allocator hands out ids from
1..num_blocks-1.  Invariants:

  free + used + RESERVED == num_blocks     (never leaks, never forges)
  refcount(b) == 0  <=>  b is on the free list
  alloc(n) is all-or-nothing

``MixerStateCache`` at the bottom is what the engine instantiates: the
composite over the per-layer layouts (``mixer_state.layer_layouts``):
the paged and ring block layouts, the recurrent slots of an SSM stack,
or both at once (the jamba hybrid), admitted all-or-nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.layers import attn_block, mla
from repro_torch.models.transformer import layer_plan
from repro_torch.serving.mixer_state import (
    LAYOUT_SLOT, MixerState, RecurrentSlotState, layer_layouts,
    ring_block_count)


class BlockAllocator:
    """Refcounted LIFO free-list over physical block ids 1..num_blocks-1."""

    RESERVED = 1  # block 0 = scratch

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is scratch)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() -> 1 first
        self._ref: dict[int, int] = {}                   # used block -> refs

    @property
    def capacity(self) -> int:
        return self.num_blocks - self.RESERVED

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> list[int] | None:
        """All-or-nothing allocation of n blocks (refcount 1 each);
        None when short."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block: int):
        if block not in self._ref:
            raise ValueError(f"incref of free/foreign block {block}")
        self._ref[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; True iff the block returned to the free
        list."""
        if block not in self._ref:
            raise ValueError(f"double/foreign free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            del self._ref[block]
            self._free.append(block)
            return True
        return False

    def free(self, blocks: list[int]):
        for b in blocks:
            self.decref(b)

    def check(self):
        """Assert the allocator invariants (used by property tests)."""
        assert self.num_free + self.num_used + self.RESERVED \
            == self.num_blocks, "block leak/forgery"
        assert not (set(self._free) & set(self._ref)), \
            "block both free and used"
        assert all(r >= 1 for r in self._ref.values()), \
            "used block with refcount 0"
        assert 0 not in self._free and 0 not in self._ref, \
            "scratch block entered circulation"


class BlockKVCache(MixerState):
    """Block-family mixer state: device pools + refcounted allocator +
    block-table assembly.  ``ring_blocks > 0`` switches the paged layout
    into the sliding-window ring layout."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int,
                 max_model_len: int, dtype=torch.float32,
                 layer_ids: list[int] | None = None, ring_blocks: int = 0,
                 device="cpu"):
        self.cfg = cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.ring_blocks = ring_blocks
        plan = layer_plan(cfg)
        if layer_ids is None:
            layer_ids = [i for i, (mix, _f) in enumerate(plan)
                         if mix != "ssm"]
        self.layer_ids = list(layer_ids)
        self.max_blocks_per_seq = -(-max_model_len // block_size)
        if ring_blocks:
            self.max_blocks_per_seq = min(self.max_blocks_per_seq,
                                          ring_blocks)
        self.allocator = BlockAllocator(num_blocks)
        self.pools = [(mla if plan[li][0] == "mla" else attn_block)
                      .init_paged_state(cfg, num_blocks, block_size, dtype,
                                        device)
                      for li in self.layer_ids]
        self.blocks_allocated = 0
        self.ring_reuses = 0             # trailing blocks recycled in place
        self.peak_used = 0               # occupancy high-water mark

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def blocks_needed(self, n_tokens: int) -> int:
        """Physical blocks a sequence of n_tokens occupies — capped at
        the ring size for the sliding-window layout."""
        n = self.blocks_for(n_tokens)
        return min(n, self.ring_blocks) if self.ring_blocks else n

    # ------------------------------------------------------ allocation

    def _alloc(self, n: int) -> list[int] | None:
        got = self.allocator.alloc(n)
        if got is not None:
            self.blocks_allocated += len(got)
            self.peak_used = max(self.peak_used, self.allocator.num_used)
        return got

    def ensure_capacity(self, req, n_tokens: int) -> bool:
        """Grow ``req.blocks`` to cover n_tokens cache slots; False if
        the pool cannot supply the missing blocks (caller preempts).
        In ring mode growth past the window allocates nothing — the
        trailing block is recycled in place (counted as a reuse)."""
        if self.ring_blocks:
            virt = self.blocks_for(n_tokens)
            prev = max(req.virtual_blocks, self.ring_blocks)
            if virt > prev:
                self.ring_reuses += virt - prev
            req.virtual_blocks = max(req.virtual_blocks, virt)
        need = self.blocks_needed(n_tokens) - len(req.blocks)
        if need <= 0:
            return True
        got = self._alloc(need)
        if got is None:
            return False
        req.blocks.extend(got)
        return True

    def release(self, req):
        if req.blocks:
            self.allocator.free(req.blocks)
        req.blocks = []

    def alloc_prompt(self, req) -> bool:
        """Admission-time allocation of the whole prompt's blocks;
        all-or-nothing, False when the pool is short."""
        got = self._alloc(self.blocks_needed(req.prompt_len))
        if got is None:
            return False
        req.blocks = got
        req.pos = 0
        req.virtual_blocks = self.blocks_for(req.prompt_len)
        return True

    # ----------------------------------------------------- block table

    def table_rows(self, reqs, batch: int) -> np.ndarray:
        """Padded (batch, max_blocks_per_seq) block table; padded rows
        and unowned slots point at scratch block 0."""
        mb = self.max_blocks_per_seq
        table = np.zeros((batch, mb), np.int32)
        for i, r in enumerate(reqs):
            if len(r.blocks) > mb:
                raise ValueError(
                    f"request {r.rid}: {len(r.blocks)} blocks exceed "
                    f"max_blocks_per_seq={mb} — the block table cannot "
                    "address them (raise max_model_len or block_size)")
            table[i, :len(r.blocks)] = r.blocks
        return table

    def stats(self) -> dict:
        cap = self.allocator.capacity
        writes = self.ring_reuses + self.blocks_allocated
        return {
            "layout": "ring" if self.ring_blocks else "paged",
            "layers": len(self.layer_ids),
            "num_blocks": cap,
            "used_blocks": self.allocator.num_used,
            "peak_used_blocks": self.peak_used,
            "occupancy": self.peak_used / cap if cap else 0.0,
            "ring_blocks": self.ring_blocks,
            "ring_reuses": self.ring_reuses,
            "ring_reuse_rate": self.ring_reuses / writes if writes else 0.0,
        }


class MixerStateCache:
    """Composite MixerState the engine instantiates: one block-family
    state (paged/ring over K/V or latent pools) and/or one slot-family
    state (recurrent slots), dispatching per layer via
    ``mixer_state.layer_layouts``.  Presents the per-layer pool list the
    step functions update in place, and passes every request-lifecycle
    call to its members all-or-nothing: a hybrid stack (jamba) admits a
    request only with a slot AND its prompt blocks."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int,
                 max_model_len: int, dtype=torch.float32,
                 num_slots: int = 8, prefill_chunk: int = 16, device="cpu"):
        self.cfg = cfg
        self.block_size = block_size
        self.layouts = layer_layouts(cfg)
        attn_ids = [i for i, l in enumerate(self.layouts)
                    if l != LAYOUT_SLOT]
        slot_ids = [i for i, l in enumerate(self.layouts)
                    if l == LAYOUT_SLOT]
        self.ring_blocks = (
            ring_block_count(cfg.sliding_window, block_size, prefill_chunk)
            if (attn_ids and cfg.sliding_window) else 0)
        self.attn = BlockKVCache(
            cfg, num_blocks=num_blocks, block_size=block_size,
            max_model_len=max_model_len, dtype=dtype, layer_ids=attn_ids,
            ring_blocks=self.ring_blocks, device=device) \
            if attn_ids else None
        self.ssm = RecurrentSlotState(cfg, slot_ids, num_slots, dtype,
                                      device) if slot_ids else None
        self._members = [m for m in (self.attn, self.ssm) if m is not None]

    # ------------------------------------------------------ device pools

    @property
    def pools(self) -> list[dict]:
        """Every member's pools, each at its layer's place."""
        out = [None] * len(self.layouts)
        for m in self._members:
            for li, p in zip(m.layer_ids, m.pools):
                out[li] = p
        return out

    # ------------------------------------------------------ capacity

    def fits(self, n_tokens: int) -> bool:
        """Can a request of n_tokens total ever be scheduled?"""
        return (self.attn is None
                or self.attn.blocks_needed(n_tokens)
                <= self.attn.allocator.capacity)

    # ------------------------------------------------------ lifecycle

    def alloc_prompt(self, req) -> bool:
        """Admission: the slot first, then the prompt's blocks.  When the
        blocks are short the slot goes back and the request is as
        before (``pos`` 0), as in the JAX package's composite; its joint
        prefix match with the slot snapshots is not ported (ROADMAP.md
        queue 1, item 7)."""
        if self.ssm is not None and not self.ssm.alloc_prompt(req):
            return False
        if self.attn is not None and not self.attn.alloc_prompt(req):
            if self.ssm is not None:
                self.ssm.release(req)
                req.pos = 0
            return False
        return True

    def ensure_capacity(self, req, n_tokens: int) -> bool:
        if self.ssm is not None and \
                not self.ssm.ensure_capacity(req, n_tokens):
            return False
        return self.attn is None or self.attn.ensure_capacity(req, n_tokens)

    def release(self, req):
        for m in self._members:
            m.release(req)

    # ------------------------------------------------------ step arrays

    @property
    def table_width(self) -> int:
        return self.attn.max_blocks_per_seq if self.attn is not None else 1

    def table_rows(self, reqs, batch: int) -> np.ndarray:
        if self.attn is not None:
            return self.attn.table_rows(reqs, batch)
        return np.zeros((batch, 1), np.int32)

    def slot_rows(self, reqs, batch: int) -> np.ndarray:
        if self.ssm is not None:
            return self.ssm.slot_rows(reqs, batch)
        return np.zeros(batch, np.int32)

    # ------------------------------------------------------ stats

    def mixer_section(self) -> dict:
        """Each member's stats: ``blocks``, ``slots`` or both."""
        out = {}
        if self.attn is not None:
            out["blocks"] = self.attn.stats()
        if self.ssm is not None:
            out["slots"] = self.ssm.stats()
        return out
