"""Block-paged mixer state: refcounted free-list allocator, content-
addressed prefix index, copy-on-write, swap-to-host, and the composite
cache over the block layouts and the recurrent slots.

``BlockKVCache`` is the block-family ``MixerState``: the device pools
hold one (num_blocks, block_size, Hkv, Dh) K and V buffer per GQA layer,
or one (num_blocks, block_size, R) c_kv and (num_blocks, block_size,
Dr) k_rope latent buffer per MLA layer; every op here is shape-generic.
This class owns the host-side bookkeeping — which physical blocks
belong to which sequence, the padded (B, max_blocks) block tables the
step functions consume — and the ownership model of the JAX package:

  * every used block carries a REFCOUNT — a block may be owned by
    several sequences at once (a shared prompt prefix) plus the prefix
    index itself; it returns to the free list only when the last
    reference drops;
  * the PREFIX INDEX maps a content hash chain (one sha256 per full
    token block, chained on the parent hash, ``chunk_key``: the JAX
    package's keys) to the physical block already holding that KV — an
    incoming prompt walks the chain and adopts every hit instead of
    re-prefilling it;
  * a shared block is NEVER written in place: ``make_writable`` copies
    it to a fresh block first (copy-on-write, ``_cow_copy``);
  * ``swap_out``/``swap_in`` move a preempted sequence's blocks to host
    memory and back — except blocks already REGISTERED in the prefix
    index, which the index keeps resident: ``swap_in`` re-adopts them
    by content hash.  If the index evicted the chain while the request
    was parked, ``swap_in`` reports the content lost and the scheduler
    falls back to recompute.  The device-to-host copy is synchronous:
    the host buffer is complete before the device blocks return to the
    free list, where the next prefill may take them at once.

With ``ring_blocks > 0`` the tables are sliding-window rings: a sequence
never owns more than ``ring_blocks`` blocks, growth past them recycles
the trailing block in place (``ring_reuses``), the table is exactly
``min(ceil(max_model_len / block_size), ring_blocks)`` wide (the step
functions take the ring's capacity from that width), and prefix
registration/matching stops at the ring depth — blocks past it get
overwritten, so only the head of the prompt is shareable.

Block 0 is reserved as a scratch block (padded rows and masked writes
are redirected there), so the allocator hands out ids from
1..num_blocks-1.  Invariants:

  free + used + RESERVED == num_blocks     (never leaks, never forges)
  refcount(b) == 0  <=>  b is on the free list
  alloc(n) is all-or-nothing

``MixerStateCache`` at the bottom is what the engine instantiates: the
composite over the per-layer layouts (``mixer_state.layer_layouts``):
the paged and ring block layouts, the recurrent slots of an SSM stack,
or both at once (the jamba hybrid), admitted all-or-nothing.  With the
prefix cache on, its slot member runs the snapshot index
(``mixer_state.SlotSnapshotIndex``) and a hybrid's admission matches
both members jointly: the attention blocks are adopted only down to the
snapshot depth, so every layer resumes from one position.  Swap parks
both members' state.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.layers import attn_block, mla
from repro_torch.models.transformer import layer_plan
from repro_torch.serving.mixer_state import (
    LAYOUT_SLOT, MixerState, RecurrentSlotState, chunk_key, layer_layouts,
    ring_block_count, split_flat, sync)
from repro_torch.serving.tracing import Tracer


def _cow_copy(pool: dict, src: int, dst: int):
    """Block ``dst`` of every tensor in one layer's pool becomes a copy
    of block ``src``, in place."""
    for v in pool.values():
        v[dst].copy_(v[src])


def _host_restore(pool: dict, dst: torch.Tensor, host: dict):
    """Write copies (n, block_size, ...) into blocks ``dst`` (n,) of one
    layer's pool, in place: one ``index_copy_`` per tensor."""
    for k, v in pool.items():
        v.index_copy_(0, dst, host[k])


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


class PrefixIndex:
    """hash-chain -> physical block, LRU-ordered for eviction.

    The index holds one reference on every entry's block, so cached KV
    survives its producing request; under pool pressure ``evict`` drops
    idle entries leaf-first in LRU order.  Each entry remembers its
    parent key: evicting a chain's head before its tail would leave
    unreachable entries that still pin blocks, so only entries no other
    entry chains from are candidates, and freeing a leaf exposes its
    parent as the next one (per-key child counts, kept incrementally)."""

    def __init__(self):
        self._map: OrderedDict[str, tuple[int, str]] = OrderedDict()
        self._children: dict[str, int] = {}   # key -> entries chained on it
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def lookup(self, key: str) -> int | None:
        entry = self._map.get(key)
        if entry is None:
            return None
        self._map.move_to_end(key)
        return entry[0]

    def peek(self, key: str) -> int | None:
        """lookup without the LRU touch: for probes that only measure
        chain depth and may never adopt the entry."""
        entry = self._map.get(key)
        return None if entry is None else entry[0]

    def insert(self, key: str, block: int, parent: str,
               allocator: BlockAllocator) -> bool:
        """Register block under key (index takes a reference); a
        duplicate key keeps the existing block."""
        if key in self._map:
            self._map.move_to_end(key)
            return False
        allocator.incref(block)
        self._map[key] = (block, parent)
        if parent:
            self._children[parent] = self._children.get(parent, 0) + 1
        return True

    def evict(self, allocator: BlockAllocator, n: int) -> int:
        """Free up to n cached blocks nobody else references (leaf
        entries in LRU order first); returns how many were freed.  A
        parent that becomes a leaf is re-examined at once."""
        freed = 0
        for key in list(self._map):
            if freed >= n:
                break
            work = [key]
            while work and freed < n:
                k = work.pop()
                if k not in self._map or self._children.get(k, 0):
                    continue                 # gone, or a chain needs it
                block, parent = self._map[k]
                if allocator.refcount(block) != 1:
                    continue                 # a sequence still reads it
                del self._map[k]
                allocator.decref(block)
                self.evictions += 1
                freed += 1
                if parent:
                    self._children[parent] -= 1
                    if not self._children[parent]:
                        del self._children[parent]
                        work.append(parent)  # newly a leaf: retry now
        return freed

    def check(self):
        """Assert the incremental child counts match a full recount and
        no surviving entry's parent was evicted from under it."""
        recount: dict[str, int] = {}
        for _, parent in self._map.values():
            if parent:
                recount[parent] = recount.get(parent, 0) + 1
        assert recount == self._children, "child counts drifted"
        for key, (_, parent) in self._map.items():
            assert not parent or parent in self._map, \
                f"entry {key} orphaned (parent evicted first)"


class BlockKVCache(MixerState):
    """Block-family mixer state: device pools + refcounted allocator +
    prefix index + block-table assembly.  ``ring_blocks > 0`` switches
    the paged layout into the sliding-window ring layout."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int,
                 max_model_len: int, dtype=torch.float32,
                 prefix_cache: bool = True,
                 layer_ids: list[int] | None = None, ring_blocks: int = 0,
                 tracer: Tracer | None = None, device="cpu"):
        self.cfg = cfg
        # wall-time accounting of the swaps goes through the tracer's
        # spans (the engine shares its tracer)
        self.tracer = tracer if tracer is not None else Tracer()
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
        self.prefix = PrefixIndex() if prefix_cache else None
        # prefix-cache counters (engine.stats surfaces these)
        self.prefix_queries = 0          # full prompt blocks walked
        self.prefix_hits = 0             # blocks adopted from the index
        self.skipped_prefill_tokens = 0  # prompt tokens never re-prefilled
        self.cow_copies = 0
        # swap counters
        self.swap_outs = 0
        self.swap_ins = 0
        self.swapped_blocks = 0          # blocks that took the host trip
        self.readopted_blocks = 0        # blocks re-adopted from the index
        self.swap_out_bytes = 0          # bytes copied device -> host
        # occupancy / ring counters
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

    def _chain_depth(self, n_full: int, max_tokens: int | None = None) -> int:
        """Full prompt blocks the index may cover: capped at the ring
        depth and at ``max_tokens``."""
        if self.ring_blocks:
            n_full = min(n_full, self.ring_blocks)
        if max_tokens is not None:
            n_full = min(n_full, max_tokens // self.block_size)
        return n_full

    def reset_stats(self, *, flush_prefix: bool = False):
        """Zero the prefix/swap counters (e.g. after a warm-up);
        ``flush_prefix`` also drops every idle cached block."""
        if self.prefix is not None:
            if flush_prefix:
                self.prefix.evict(self.allocator, len(self.prefix))
            self.prefix.evictions = 0
        self.prefix_queries = self.prefix_hits = 0
        self.skipped_prefill_tokens = self.cow_copies = 0
        self.swap_outs = self.swap_ins = self.swapped_blocks = 0
        self.readopted_blocks = self.swap_out_bytes = 0
        self.tracer.reset_spans("swap_out", "swap_in")
        self.blocks_allocated = self.ring_reuses = 0
        self.peak_used = self.allocator.num_used

    # ------------------------------------------------------ allocation

    def _alloc(self, n: int) -> list[int] | None:
        """alloc, evicting idle prefix-cached blocks under pressure."""
        got = self.allocator.alloc(n)
        if got is None and self.prefix is not None:
            self.prefix.evict(self.allocator, n - self.allocator.num_free)
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

    # ---------------------------------------------------- prefix cache

    def match_prefix(self, prompt: np.ndarray,
                     max_tokens: int | None = None, *, touch: bool = True
                     ) -> tuple[list[int], int, str]:
        """Walk the prompt's full-block hash chain through the index.

        Returns (matched block ids NOT yet increfed, tokens covered,
        chain key of the last match).  A full-prompt match keeps every
        block but re-prefills the final token, so the caller always has
        one prefill position left to produce first-token logits (the
        write lands in a shared block — copy-on-write handles it).
        ``max_tokens`` caps the match depth: a hybrid stack passes the
        slot snapshot depth, so both families resume from one position.
        ``touch=False`` probes without promoting entries in LRU order
        (the hybrid's depth probe may never adopt what it measures)."""
        if self.prefix is None or not len(self.prefix):
            return [], 0, ""
        bs = self.block_size
        n_full = self._chain_depth(len(prompt) // bs, max_tokens)
        blocks, parent = [], ""
        for j in range(n_full):
            key = chunk_key(parent, prompt[j * bs:(j + 1) * bs])
            b = self.prefix.lookup(key) if touch else self.prefix.peek(key)
            if b is None:
                break
            blocks.append(b)
            parent = key
        n_tok = len(blocks) * bs
        if n_tok >= len(prompt):
            n_tok = len(prompt) - 1
        return blocks, n_tok, parent

    def alloc_prompt(self, req, max_match: int | None = None) -> bool:
        """Admission-time allocation: adopt prefix-cached blocks for the
        matched prompt head, allocate fresh blocks for the rest, and
        start the request at ``pos = matched tokens`` (prefill skip).
        All-or-nothing; False when the pool is short."""
        matched, n_tok, parent = self.match_prefix(req.prompt, max_match)
        for b in matched:           # pin before _alloc may evict LRU entries
            self.allocator.incref(b)
        got = self._alloc(self.blocks_needed(req.prompt_len) - len(matched))
        if got is None:
            for b in matched:
                self.allocator.decref(b)
            return False
        req.blocks = matched + got
        req.pos = n_tok
        req.skipped_prefill = n_tok
        req.n_registered = len(matched)
        req.prefix_key = parent
        req.virtual_blocks = self.blocks_for(req.prompt_len)
        # counted only on successful admission: a deferred request
        # re-matches every retry and would otherwise deflate hit_rate
        if self.prefix is not None:
            n_full = self._chain_depth(req.prompt_len // self.block_size,
                                       max_match)
            self.prefix_queries += min(len(matched) + 1, n_full)
            self.prefix_hits += len(matched)
        self.skipped_prefill_tokens += n_tok
        return True

    def register_prefix(self, req):
        """Publish req's freshly prefilled FULL prompt blocks into the
        index (content-hash chained after the already-registered head);
        a ring stops at its depth."""
        if self.prefix is None:
            return
        bs = self.block_size
        n_full = self._chain_depth(min(req.pos, req.prompt_len) // bs)
        while req.n_registered < n_full:
            j = req.n_registered
            key = chunk_key(req.prefix_key, req.prompt[j * bs:(j + 1) * bs])
            self.prefix.insert(key, req.blocks[j], req.prefix_key,
                               self.allocator)
            req.prefix_key = key
            req.n_registered += 1

    # --------------------------------------------------- copy-on-write

    def writable_indices(self, pos: int, n: int) -> range:
        """Logical block indices a write of n tokens at pos touches
        (virtual — ``make_writable`` maps them into the ring)."""
        bs = self.block_size
        return range(pos // bs, (pos + n - 1) // bs + 1)

    def make_writable(self, req, idx: int) -> bool:
        """Copy-on-write: if req's idx-th block is shared, move req onto
        a private copy before it is written.  False when no block is
        available for the copy (caller preempts)."""
        if self.ring_blocks:
            idx = idx % self.ring_blocks
        block = req.blocks[idx]
        if self.allocator.refcount(block) == 1:
            return True
        got = self._alloc(1)
        if got is None:
            return False
        for pool in self.pools:
            _cow_copy(pool, block, got[0])
        self.allocator.decref(block)
        req.blocks[idx] = got[0]
        self.cow_copies += 1
        return True

    # ---------------------------------------------------- swap-to-host

    def _device(self):
        return next(iter(self.pools[0].values())).device

    def swap_out(self, req, peer: "BlockKVCache | None" = None):
        """Park req's blocks off the device.  Blocks REGISTERED in the
        prefix index skip the copy — the index keeps them resident and
        ``swap_in`` re-adopts them by content hash (a ring that wrapped
        no longer maps its leading blocks to the chain, so it copies
        all).  The rest are copied to host memory, synchronously, before
        req drops every device reference.

        ``peer`` makes it SWAP-TO-PEER: the re-adoption depth is walked
        against the PEER's prefix index instead — leading blocks whose
        hash chain the destination already holds are not copied (its
        ``swap_in`` re-adopts them there), only the tail is — and the
        request's prefix registration is rebased onto that chain, so it
        resumes on the destination."""
        sync(self._device())
        with self.tracer.span("swap_out", rid=req.rid) as sp:
            readopt = 0
            no_wrap = self.blocks_for(req.pos) <= (self.ring_blocks
                                                   or self.max_blocks_per_seq)
            if peer is not None:
                bs = self.block_size
                parent = ""
                if peer.prefix is not None and no_wrap:
                    n_full = min(req.pos, req.prompt_len) // bs
                    if self.ring_blocks:
                        n_full = min(n_full, self.ring_blocks)
                    while readopt < n_full:
                        key = chunk_key(
                            parent,
                            req.prompt[readopt * bs:(readopt + 1) * bs])
                        if peer.prefix.peek(key) is None:
                            break
                        parent = key
                        readopt += 1
                req.n_registered = readopt
                req.prefix_key = parent
            elif self.prefix is not None and req.n_registered and no_wrap:
                readopt = req.n_registered
            ids = torch.tensor(req.blocks[readopt:], dtype=torch.long,
                               device=self._device())
            # one gather on the device, one synchronous copy to the host
            # (pageable memory: the copy is complete when .cpu() returns)
            flat = torch.cat([v.index_select(0, ids).reshape(-1)
                              for pool in self.pools
                              for v in pool.values()]).cpu()
            host = split_flat(flat, [{k: (len(ids),) + tuple(v.shape[1:])
                                  for k, v in pool.items()}
                                 for pool in self.pools])
            req.host_kv = host
            req.swap_readopt = readopt
            self.allocator.free(req.blocks)
            req.blocks = []
            self.swap_outs += 1
            self.swapped_blocks += len(ids)
            n_bytes = flat.numel() * flat.element_size()
            self.swap_out_bytes += n_bytes
            sp.extra["blocks"] = len(ids)
            sp.extra["bytes"] = n_bytes

    def swap_in(self, req) -> bool | None:
        """Restore a swapped request.  Registered blocks are re-adopted
        from the prefix index (content hash -> resident block, no copy);
        the rest get fresh blocks and their host copies.  False when the
        pool is short; None when a registered block's chain was evicted
        while parked — the content is gone and the caller must fall back
        to recompute."""
        bs = self.block_size
        adopted, parent = [], ""
        for j in range(req.swap_readopt):
            key = chunk_key(parent, req.prompt[j * bs:(j + 1) * bs])
            b = self.prefix.lookup(key) if self.prefix is not None else None
            if b is None:
                for a in adopted:
                    self.allocator.decref(a)
                return None
            self.allocator.incref(b)
            adopted.append(b)
            parent = key
        n = next(iter(req.host_kv[0].values())).shape[0]
        got = self._alloc(n)
        if got is None:
            for a in adopted:
                self.allocator.decref(a)
            return False
        dev = self._device()
        sync(dev)
        with self.tracer.span("swap_in", rid=req.rid, blocks=n):
            dst = torch.tensor(got, dtype=torch.long, device=dev)
            shapes = [{k: tuple(a.shape) for k, a in layer.items()}
                      for layer in req.host_kv]
            # one copy to the device of the whole buffer that swap_out's
            # per-layer views share, then one scatter a tensor
            flat = next(iter(req.host_kv[0].values()))._base
            if flat is None:
                flat = torch.cat([a.reshape(-1) for layer in req.host_kv
                                  for a in layer.values()])
            for pool, layer in zip(self.pools, split_flat(flat.to(dev), shapes)):
                _host_restore(pool, dst, layer)
            sync(dev)                  # the span covers the copies
        req.blocks = adopted + got
        req.host_kv = None
        req.swap_readopt = 0
        self.swap_ins += 1
        self.readopted_blocks += len(adopted)
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
    state (recurrent slots and their snapshot index), dispatching per
    layer via ``mixer_state.layer_layouts``.  Presents the per-layer pool
    list the step functions update in place, and passes every
    request-lifecycle call to its members all-or-nothing: a hybrid stack
    (jamba) admits a request only with a slot AND its prompt blocks."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int,
                 max_model_len: int, dtype=torch.float32,
                 prefix_cache: bool = True, num_slots: int = 8,
                 prefill_chunk: int = 16, snapshot_slots: int = 16,
                 tracer: Tracer | None = None, device="cpu"):
        self.cfg = cfg
        self.tracer = tracer if tracer is not None else Tracer()
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
            max_model_len=max_model_len, dtype=dtype,
            prefix_cache=prefix_cache, layer_ids=attn_ids,
            ring_blocks=self.ring_blocks, tracer=self.tracer,
            device=device) if attn_ids else None
        # the slot member's snapshot index is the prefix cache of its
        # layers, on or off with the block member's
        self.ssm = RecurrentSlotState(
            cfg, slot_ids, num_slots, dtype, device, block_size=block_size,
            snapshot_slots=snapshot_slots if prefix_cache else 0,
            prefill_chunk=prefill_chunk, tracer=self.tracer) \
            if slot_ids else None
        self._members = [m for m in (self.attn, self.ssm) if m is not None]
        self.swap_outs = 0          # by request (a hybrid swaps both
        self.swap_ins = 0           # members in one event)

    # ------------------------------------------------------ device pools

    @property
    def pools(self) -> list[dict]:
        """Every member's pools, each at its layer's place."""
        out = [None] * len(self.layouts)
        for m in self._members:
            for li, p in zip(m.layer_ids, m.pools):
                out[li] = p
        return out

    @property
    def prefix(self):
        return self.attn.prefix if self.attn is not None else None

    # ------------------------------------------------------ capacity

    def fits(self, n_tokens: int) -> bool:
        """Can a request of n_tokens total ever be scheduled?"""
        return (self.attn is None
                or self.attn.blocks_needed(n_tokens)
                <= self.attn.allocator.capacity)

    # ------------------------------------------------------ lifecycle

    def alloc_prompt(self, req) -> bool:
        """Admission with a JOINT prefix match: every layer must resume
        prefill from one position, so the attention chain's depth and the
        snapshot depth are reconciled to their common prefix.  The
        attention member adopts blocks only down to the snapshot depth,
        the slot member restores that snapshot, and the request starts
        past the matched tokens.  A hybrid without snapshots adopts
        nothing (its slot would still be computed from position 0).  The
        slot is taken first; when the blocks are short it goes back and
        the request is as before (``pos`` 0).

        Scoring requests adopt nothing either: teacher-forced scoring
        needs the LOGITS of every prompt position, and an adopted prefix
        skips exactly those forwards (the blocks hold KV, not logits).
        Their freshly prefilled blocks still register in the index for
        later requests to reuse."""
        if req.score:
            if self.ssm is not None and \
                    not self.ssm.alloc_prompt(req, (0, "", 0), count=False):
                return False
            if self.attn is not None and \
                    not self.attn.alloc_prompt(req, max_match=0):
                if self.ssm is not None:
                    self.ssm.release(req)
                    req.pos = req.skipped_prefill = 0
                return False
            return True
        cap = None
        match = (0, "", 0)
        if self.ssm is not None:
            limit = None
            if self.attn is not None and self.ssm.snapshots is not None:
                # probe the chain first, without an LRU touch (entries
                # past the snapshot depth are never adopted): a snapshot
                # deeper than the adoptable chain cannot be resumed from
                _, limit, _ = self.attn.match_prefix(req.prompt, touch=False)
            match = self.ssm.match_prefix(req.prompt, limit=limit)
            cap = match[0]
            if not self.ssm.alloc_prompt(req, match, count=False):
                return False
        if self.attn is not None and \
                not self.attn.alloc_prompt(req, max_match=cap):
            if self.ssm is not None:
                self.ssm.release(req)
                req.pos = req.skipped_prefill = 0
                req.snap_registered, req.snap_key = 0, ""
            return False
        if self.ssm is not None:
            self.ssm.count_match(match)
        return True

    def ensure_capacity(self, req, n_tokens: int) -> bool:
        if self.ssm is not None and \
                not self.ssm.ensure_capacity(req, n_tokens):
            return False
        return self.attn is None or self.attn.ensure_capacity(req, n_tokens)

    def release(self, req):
        for m in self._members:
            m.release(req)

    def make_writable(self, req, idx: int) -> bool:
        return self.attn is None or self.attn.make_writable(req, idx)

    def writable_indices(self, pos: int, n: int) -> range:
        if self.attn is None:
            return range(0)
        return self.attn.writable_indices(pos, n)

    def register_prefix(self, req):
        if self.attn is not None:
            self.attn.register_prefix(req)
        if self.ssm is not None:
            self.ssm.register_snapshot(req)

    def swap_out(self, req, peer: "MixerStateCache | None" = None):
        """Park both members; ``peer`` (the destination's composite, for
        swap-to-peer) hands each member its counterpart's index."""
        if self.attn is not None and req.blocks:
            self.attn.swap_out(req, peer=peer.attn if peer else None)
        if self.ssm is not None and req.slot is not None:
            self.ssm.swap_out(req, peer=peer.ssm if peer else None)
        self.swap_outs += 1

    def swap_in(self, req) -> bool | None:
        """Restore both members, or neither: the slot member's checks run
        before any block is restored, so nothing has to be rolled back."""
        if self.ssm is not None:
            # the re-adoption peek first: an evicted snapshot sends the
            # whole request to recompute before any block is restored
            if req.snap_readopt and (
                    self.ssm.snapshots is None
                    or self.ssm.snapshots.lookup(req.snap_key) is None):
                return None
            if req.slot is None and self.ssm.allocator.num_free < 1:
                return False
        if self.attn is not None and req.host_kv is not None:
            ok = self.attn.swap_in(req)
            if ok is not True:
                return ok
        if self.ssm is not None and (req.host_state is not None
                                     or req.snap_readopt):
            restored = self.ssm.swap_in(req)
            assert restored, "the slot checks above guarantee success"
        self.swap_ins += 1
        return True

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

    def reset_stats(self, *, flush_prefix: bool = False):
        if self.attn is not None:
            self.attn.reset_stats(flush_prefix=flush_prefix)
        if self.ssm is not None:
            self.ssm.reset_stats(flush_snapshots=flush_prefix)
        self.swap_outs = self.swap_ins = 0

    def prefix_section(self) -> dict:
        """The JAX package's keys."""
        a, s = self.attn, self.ssm
        snaps = s.snapshots if s is not None else None
        on = a is not None and a.prefix is not None
        queries = (a.prefix_queries if a else 0) \
            + (s.snap_queries if s else 0)
        hits = (a.prefix_hits if a else 0) + (s.snap_hits if s else 0)
        # a hybrid's joint match skips the same tokens in both members:
        # counted once
        skipped = (a.skipped_prefill_tokens if a is not None
                   else (s.skipped_prefill_tokens if s else 0))
        return {
            "enabled": on or snaps is not None,
            "queries": queries,
            "hits": hits,
            "hit_rate": hits / queries if queries else 0.0,
            "skipped_prefill_tokens": skipped,
            "cow_copies": a.cow_copies if a else 0,
            "cached_blocks": len(a.prefix) if on else 0,
            "evictions": a.prefix.evictions if on else 0,
            "snapshot_queries": s.snap_queries if s else 0,
            "snapshot_hits": s.snap_hits if s else 0,
            "snapshot_stores": snaps.stores if snaps else 0,
            "cached_snapshots": len(snaps) if snaps else 0,
            "snapshot_evictions": snaps.evictions if snaps else 0,
            "snapshot_occupancy": (snaps.peak_used / snaps.capacity
                                   if snaps else 0.0),
        }

    def swap_section(self) -> dict:
        """The JAX package's keys, plus the bytes copied to the host."""
        a, s = self.attn, self.ssm
        tr = self.tracer
        return {
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swapped_blocks": a.swapped_blocks if a else 0,
            "readopted_blocks": a.readopted_blocks if a else 0,
            "swapped_slots": s.swapped_slots if s else 0,
            "readopted_snapshots": s.readopted_snapshots if s else 0,
            "swap_out_bytes": sum(m.swap_out_bytes for m in self._members),
            "swap_out_s": (tr.span_total("swap_out")
                           + tr.span_total("snapshot_out")),
            "swap_in_s": (tr.span_total("swap_in")
                          + tr.span_total("snapshot_in")),
        }

    def mixer_section(self) -> dict:
        """Each member's stats: ``blocks``, ``slots`` or both."""
        out = {}
        if self.attn is not None:
            out["blocks"] = self.attn.stats()
        if self.ssm is not None:
            out["slots"] = self.ssm.stats()
        return out
