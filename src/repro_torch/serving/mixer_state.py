"""MixerState: the request-lifecycle protocol of a per-layer cache
layout, and the recurrent slot layout with its snapshot index.

The port runs the JAX package's three layouts through this protocol:
  * paged K/V or MLA latent blocks and (``ring_blocks > 0``) the
    window-sized ring tables of sliding-window stacks, both in
    ``block_cache.BlockKVCache``;
  * per-request recurrent slots (``RecurrentSlotState`` below): SSM
    (mamba2 SSD) layers keep O(1) state per request, one slot of a
    fixed pool holding (hidden state, conv tail); no block table,
    nothing pages; swap copies the whole slot to the host and back.
``layer_layouts`` names every layer's layout.

Recurrent state cannot be adopted by aliasing storage, but it can be
replayed: ``SlotSnapshotIndex`` keeps a fixed device pool of
whole-state snapshots captured at block-aligned prefill boundaries,
keyed by the same sha256 hash chain as the block family's
``PrefixIndex`` (``chunk_key``).  An incoming prompt restores the
deepest matching snapshot into its slot and starts prefill past it, so
mamba2 and jamba traffic skips shared prompt heads too.
"""
from __future__ import annotations

import abc
import hashlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.dist import spmd
from repro_torch.layers import mamba2
from repro_torch.models import transformer
from repro_torch.models.transformer import layer_plan
from repro_torch.serving.tracing import Tracer

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


def chunk_key(parent: str, tokens: np.ndarray) -> str:
    """Content hash of one full token block, chained on the parent
    block's key so equal windows at different prefix depths differ (the
    JAX package's ``chunk_key``: the same keys).  Shared by the block
    family's ``PrefixIndex`` and ``SlotSnapshotIndex``: one prompt walks
    one chain."""
    h = hashlib.sha256()
    h.update(parent.encode())
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.hexdigest()


def sync(dev: torch.device):
    """Wait for the device's queued work, so that a span measures the
    copies that follow and not what was queued before them."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def split_flat(flat: torch.Tensor, like: list[dict]) -> list[dict]:
    """Per-layer dicts of views into one flat buffer, shaped as the
    tensors of ``like`` (name -> shape), in their order."""
    out, at = [], 0
    for layer in like:
        views = {}
        for k, shape in layer.items():
            n = int(np.prod(shape))
            views[k] = flat[at:at + n].view(shape)
            at += n
        out.append(views)
    return out


class MixerState(abc.ABC):
    """Request-lifecycle protocol every mixer-state layout implements.

    A layout owns the device pools for ITS layers plus whatever
    bookkeeping maps a request onto them (block lists, slot ids).  The
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


class SlotSnapshotIndex:
    """content hash -> snapshot row over a fixed device pool of
    recurrent-state captures, LRU-ordered for eviction.

    Each row holds one layer stack's (SSD hidden state, conv tail)
    exactly as it stood after some block-aligned prompt prefix (over a
    mesh the rank's slices, placed as the live pools).  Entries
    are STANDALONE (a snapshot captures the whole state at its depth),
    so unlike ``PrefixIndex`` there is no parent chaining, nothing can
    be orphaned, and eviction is plain LRU row recycling."""

    def __init__(self, cfg, n_layers: int, capacity: int,
                 dtype=torch.float32, device="cpu", *, mesh=None,
                 layer_ids: list[int] | None = None):
        if capacity < 1:
            raise ValueError("need at least one snapshot slot")
        self.capacity = capacity
        self.pools = [mamba2.init_paged_state(cfg, capacity, dtype, device)
                      for _ in range(n_layers)]
        if mesh is not None:    # the live pools' layers, placed as they are
            self.pools = transformer.place_pools(cfg, self.pools, layer_ids,
                                                 mesh)
        self._map: OrderedDict[str, int] = OrderedDict()  # key -> row
        self._free = list(range(capacity))
        self.stores = 0
        self.evictions = 0
        self.peak_used = 0

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def lookup(self, key: str) -> int | None:
        row = self._map.get(key)
        if row is not None:
            self._map.move_to_end(key)
        return row

    def store(self, key: str, live_pools: list, slot: int) -> bool:
        """Capture ``slot``'s state from every layer's live pool under
        ``key``; recycles the LRU row when the pool is full.  A
        duplicate key keeps the existing snapshot (the state under one
        content hash is deterministic, so it is the same bits)."""
        if key in self._map:
            self._map.move_to_end(key)
            return False
        if not self._free:
            _, row = self._map.popitem(last=False)       # LRU entry
            self._free.append(row)
            self.evictions += 1
        row = self._free.pop()
        for pool, live in zip(self.pools, live_pools):
            mamba2.copy_slot(pool, row, live, slot)
        self._map[key] = row
        self.stores += 1
        self.peak_used = max(self.peak_used, len(self._map))
        return True

    def flush(self):
        """Drop every entry (rows return to the free list)."""
        self._free.extend(self._map.values())
        self._map.clear()

    def reset_stats(self):
        self.stores = self.evictions = 0
        self.peak_used = len(self._map)


class RecurrentSlotState(MixerState):
    """Per-request recurrent slots: the SSM mixer-state layout.

    Pool per layer: (num_slots, ...) SSD hidden state + conv tail.  Slot
    0 is scratch (padded batch rows write there).  A request owns one
    slot for its whole life, whatever its length; a slot is zeroed when
    it is handed out, since its previous owner's state is still in it,
    and copied whole on swap.

    Over a mesh (``mesh=``) the pools are DTensors placed by
    ``transformer.paged_state_specs``: each rank holds its heads of every
    slot's ``h`` and the whole conv tail, and zeroing, snapshot copies
    and swap act on the rank's slices (a swapped slot's host copy is the
    rank's slices).

    With ``snapshot_slots > 0`` the layout also runs a
    ``SlotSnapshotIndex``: block-aligned prefill states are published
    under the prompt's hash chain, an incoming prompt restores the
    deepest matching snapshot and starts prefill past it
    (``match_prefix`` / ``alloc_prompt``), and a request parked by swap
    exactly AT a registered snapshot skips the host trip: swap-in
    re-adopts the snapshot by hash, or reports it lost (``swap_lost``,
    recompute) when it was evicted while parked.
    """

    def __init__(self, cfg, layer_ids: list[int], num_slots: int,
                 dtype=torch.float32, device="cpu", *, block_size: int = 0,
                 snapshot_slots: int = 0, prefill_chunk: int = 0,
                 tracer: Tracer | None = None, mesh=None):
        # BlockAllocator's free list with the reserved id 0 and its
        # invariant checks is what a slot pool needs (slots are blocks
        # that are never shared)
        from repro_torch.serving.block_cache import BlockAllocator
        self.cfg = cfg
        # the swap copies' wall time goes through the tracer's spans
        # (the engine shares its tracer)
        self.tracer = tracer if tracer is not None else Tracer()
        self.layer_ids = list(layer_ids)
        self.num_slots = num_slots
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.allocator = BlockAllocator(num_slots)
        self.pools = transformer.place_pools(
            cfg, [mamba2.init_paged_state(cfg, num_slots, dtype, device)
                  for _ in self.layer_ids], self.layer_ids, mesh)
        self.snapshots = (
            SlotSnapshotIndex(cfg, len(self.layer_ids), snapshot_slots,
                              dtype, device, mesh=mesh,
                              layer_ids=self.layer_ids)
            if snapshot_slots > 0 and block_size > 0 else None)
        self.peak_used = 0
        self.swapped_slots = 0           # slots that took the host trip
        self.swap_out_bytes = 0          # bytes copied device -> host
        # snapshot-index counters (engine.stats surfaces these)
        self.snap_queries = 0            # full prompt blocks walked
        self.snap_hits = 0               # blocks-worth of state adopted
        self.skipped_prefill_tokens = 0  # prompt tokens never re-prefilled
        self.readopted_snapshots = 0     # swap-ins served from the index

    def reset_stats(self, *, flush_snapshots: bool = False):
        self.peak_used = 0
        self.tracer.reset_spans("snapshot_out", "snapshot_in")
        self.swapped_slots = self.swap_out_bytes = 0
        self.snap_queries = self.snap_hits = 0
        self.skipped_prefill_tokens = self.readopted_snapshots = 0
        if self.snapshots is not None:
            if flush_snapshots:
                self.snapshots.flush()
            self.snapshots.reset_stats()

    # ---------------------------------------------------- prefix match

    def match_prefix(self, prompt: np.ndarray, limit: int | None = None
                     ) -> tuple[int, str, int]:
        """(adoptable tokens, snapshot key, full blocks walked).

        Snapshots are standalone whole-state captures, so a missing depth
        does not block a deeper hit: the deepest present entry wins.
        Depth is capped at prompt_len - 1: one prompt token must still
        prefill to produce first-token logits, and re-running it from a
        full-prompt snapshot would fold it into the recurrent state
        twice.  ``limit`` (hybrid stacks) also caps the depth at the
        attention chain's matched depth: every layer resumes from one
        position."""
        if self.snapshots is None:
            return 0, "", 0
        bs = self.block_size
        n_full = (len(prompt) - 1) // bs
        if limit is not None:
            n_full = min(n_full, limit // bs)
        if not len(self.snapshots):
            return 0, "", n_full       # nothing to hash against
        best_tok, best_key, parent = 0, "", ""
        for j in range(n_full):
            key = chunk_key(parent, prompt[j * bs:(j + 1) * bs])
            if key in self.snapshots:
                best_tok, best_key = (j + 1) * bs, key
            parent = key
        if best_key:
            self.snapshots.lookup(best_key)      # LRU-touch the winner
        return best_tok, best_key, n_full

    # ------------------------------------------------------- lifecycle

    def alloc_prompt(self, req, match: tuple[int, str, int] = (0, "", 0),
                     count: bool = True) -> bool:
        """Admission: give req a slot and, when ``match`` (from
        ``match_prefix``) names a snapshot, restore it and start the
        request past the matched tokens (prefill skip).  ``count=False``
        leaves the counting to the caller: the composite counts only once
        the whole admission succeeded."""
        n_tok, key, _walked = match
        if not (self._take_slot(req) if n_tok else self._alloc_slot(req)):
            return False
        if n_tok:
            row = self.snapshots.lookup(key)
            # nothing between match and here evicts snapshot entries
            assert row is not None, "matched snapshot vanished"
            self._restore_row(req.slot, row)
            req.pos = n_tok
            req.skipped_prefill = n_tok
            req.snap_registered = n_tok // self.block_size
            req.snap_key = key
        if count:
            self.count_match(match)
        return True

    def count_match(self, match: tuple[int, str, int]):
        """Fold one admitted request's match into the hit counters (a
        deferred request re-matches at every retry and is not counted)."""
        if self.snapshots is None:
            return
        n_tok, _key, walked = match
        hits = n_tok // self.block_size if n_tok else 0
        self.snap_queries += min(hits + 1, walked)
        self.snap_hits += hits
        self.skipped_prefill_tokens += n_tok

    def register_snapshot(self, req):
        """Publish req's current recurrent state into the snapshot index
        when it sits at a block boundary on the chunk grid.

        Two alignment rules: a block boundary crossed mid-chunk has no
        materialised state (the hash chain still walks through its
        blocks), and a position that ends a chunk without being a chunk
        multiple (a prompt's partial final chunk can end block-aligned)
        is not captured either: a request resuming there would prefill
        on a shifted chunk grid, and the SSD dual form's float sums
        differ across groupings, so its tokens could differ from a run
        without snapshots."""
        if self.snapshots is None:
            return
        bs = self.block_size
        pos = req.pos
        if pos == 0 or pos > req.prompt_len or pos % bs:
            return
        if self.prefill_chunk > 1 and pos % self.prefill_chunk:
            return
        depth = pos // bs
        if depth <= req.snap_registered:
            return
        key = req.snap_key
        for j in range(req.snap_registered, depth):
            key = chunk_key(key, req.prompt[j * bs:(j + 1) * bs])
        self.snapshots.store(key, self.pools, req.slot)
        req.snap_registered = depth
        req.snap_key = key

    def ensure_capacity(self, req, n_tokens: int) -> bool:
        return self._alloc_slot(req)

    def _alloc_slot(self, req) -> bool:
        """Give req a zeroed slot if it lacks one; False when none is
        free (its previous owner's state is still in it)."""
        had = req.slot is not None
        if not self._take_slot(req):
            return False
        if not had:
            for pool in self.pools:
                for v in pool.values():
                    spmd.local(v)[req.slot] = 0.0
        return True

    def _take_slot(self, req) -> bool:
        """Give req a slot if it lacks one, as it is: for a restore, which
        overwrites the whole slot."""
        if req.slot is not None:
            return True
        got = self.allocator.alloc(1)
        if got is None:
            return False
        req.slot = got[0]
        self.peak_used = max(self.peak_used, self.allocator.num_used)
        return True

    def _restore_row(self, slot: int, row: int):
        for pool, snap in zip(self.pools, self.snapshots.pools):
            mamba2.copy_slot(pool, slot, snap, row)

    def release(self, req):
        if req.slot is not None:
            self.allocator.free([req.slot])
            req.slot = None

    def _device(self):
        return spmd.local(self.pools[0]["h"]).device

    def swap_out(self, req, peer: "RecurrentSlotState | None" = None):
        """Park req's slot off the device.  A request parked exactly at a
        snapshot still resident in the index skips the copy: swap_in
        re-adopts it by content hash (an entry evicted before swap_in
        falls back to recompute).  Otherwise the slot is copied to host
        memory, synchronously (one gather, one copy to the host), before
        the slot returns to the free list.  ``peer`` (swap-to-peer)
        decides re-adoption against the PEER's snapshot index: when the
        destination holds the snapshot of the parked depth, no state
        crosses shards."""
        dev = self._device()
        sync(dev)
        with self.tracer.span("snapshot_out", rid=req.rid) as sp:
            bs = self.block_size
            index = self.snapshots if peer is None else peer.snapshots
            if (index is not None and req.pos
                    and req.pos <= req.prompt_len and req.pos % bs == 0
                    and req.snap_registered == req.pos // bs
                    and req.snap_key in index):
                req.snap_readopt = True
                sp.extra["bytes"] = 0        # the index keeps the content
            else:
                s = req.slot
                local = [{k: spmd.local(v) for k, v in pool.items()}
                         for pool in self.pools]
                flat = torch.cat([v[s].reshape(-1) for pool in local
                                  for v in pool.values()]).cpu()
                req.host_state = split_flat(
                    flat, [{k: tuple(v.shape[1:]) for k, v in pool.items()}
                           for pool in local])
                self.swapped_slots += 1
                n_bytes = flat.numel() * flat.element_size()
                self.swap_out_bytes += n_bytes
                sp.extra["bytes"] = n_bytes
            self.release(req)

    def swap_in(self, req) -> bool | None:
        """Restore a swapped request's slot: from the snapshot index
        (re-adoption) or from its host copy.  False when no slot is
        free; None when the parked snapshot was evicted meanwhile (the
        caller falls back to recompute)."""
        if req.snap_readopt:
            # req.snap_key is the chain key at the parked depth (swap_out
            # required snap_registered == pos // bs)
            row = (self.snapshots.lookup(req.snap_key)
                   if self.snapshots is not None else None)
            if row is None:
                return None              # evicted while parked: recompute
            if not self._take_slot(req):
                return False
            with self.tracer.span("snapshot_in", rid=req.rid, readopt=True):
                self._restore_row(req.slot, row)
            req.snap_readopt = False
            self.readopted_snapshots += 1
            return True
        if not self._take_slot(req):
            return False
        dev = self._device()
        sync(dev)
        with self.tracer.span("snapshot_in", rid=req.rid):
            # one copy of the buffer the per-layer views share, then a
            # slot write a tensor
            flat = req.host_state[0]["h"]._base
            if flat is None:
                flat = torch.cat([a.reshape(-1) for layer in req.host_state
                                  for a in layer.values()])
            shapes = [{k: tuple(a.shape) for k, a in layer.items()}
                      for layer in req.host_state]
            for pool, host in zip(self.pools, split_flat(flat.to(dev),
                                                         shapes)):
                for k, v in pool.items():
                    spmd.local(v)[req.slot].copy_(host[k])
            sync(dev)                    # the span covers the copies
            req.host_state = None
        return True

    # ------------------------------------------------------------ step

    def slot_rows(self, reqs, batch: int) -> np.ndarray:
        """(batch,) slot ids; padded rows point at scratch slot 0."""
        slots = np.zeros(batch, np.int32)
        for i, r in enumerate(reqs):
            slots[i] = 0 if r.slot is None else r.slot
        return slots

    def stats(self) -> dict:
        cap = self.allocator.capacity
        s = self.snapshots
        return {
            "layout": LAYOUT_SLOT,
            "layers": len(self.layer_ids),
            "num_slots": cap,
            "used_slots": self.allocator.num_used,
            "peak_used_slots": self.peak_used,
            "occupancy": self.peak_used / cap if cap else 0.0,
            "swapped_slots": self.swapped_slots,
            "snapshot_slots": s.capacity if s else 0,
            "cached_snapshots": len(s) if s else 0,
            "snapshot_occupancy": s.peak_used / s.capacity if s else 0.0,
        }
