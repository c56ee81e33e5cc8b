"""Prefix cache and swap-to-host of the port against the JAX package.

Cache level (``BlockKVCache``, the cases of tests/test_prefix_swap.py):
a prompt adopts the registered blocks of its hash chain (``chunk_key``,
the JAX package's keys), a full match keeps one token to prefill, a
shared block is copied before it is written, idle cached blocks are
evicted under pressure, a swap round trip restores the blocks' bytes,
and a swap whose re-adoptable chain was evicted reports the loss.

Engine level: the reduced bnn-lm-100m, mixtral (sliding-window ring)
and deepseek-v2-lite (MLA latents) engines under the JAX engine's
defaults (prefix cache on, swap preemption) on one seeded Poisson trace
with a shared prompt head, a whole repeated prompt and a pool small
enough to swap: tokens equal to the JAX engine's, the ``prefix_cache``
and ``swap`` stats counts (not wall times), ``preemptions`` and the
scheduler's event sequence equal too; greedy tokens equal to the same
trace without the prefix cache and under recompute (sampled decoding
on the same trace: tests/test_torch_sampling.py).  Stacks with
recurrent slots under both options: tests/test_torch_slot_snapshots.py.

The JAX side runs its XLA paths, the port its plain kernel versions on
the CPU; every comparison here is exact (equal tokens, equal counts,
bit-equal bytes)."""
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.serving import BlockKVCache as JCache
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving.mixer_state import chunk_key as jchunk_key
from repro_torch.serving import (BlockKVCache, Engine, EngineConfig,
                                 Request, State, chunk_key)

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"


@pytest.fixture(scope="module")
def bnn_cfg():
    return F.cfgs(ARCH, "bnn")[1]


def _cache(cfg, **kw):
    defaults = dict(num_blocks=17, block_size=4, max_model_len=32)
    defaults.update(kw)
    return BlockKVCache(cfg, **defaults)


def _req(rid, prompt):
    return Request(rid, np.asarray(prompt, np.int32), 4)


# ---------------------------------------------------------- cache level


@pytest.mark.parametrize("parent", ["", "ab" * 32])
def test_chunk_key_equals_jax(parent):
    toks = np.random.default_rng(len(parent)).integers(0, 32000, 16)
    assert chunk_key(parent, toks) == jchunk_key(parent, toks)
    assert chunk_key(parent, toks.astype(np.int64)) == chunk_key(parent, toks)


def test_prefix_match_adopts_registered_blocks(bnn_cfg):
    cache = _cache(bnn_cfg)
    prompt = np.arange(10, dtype=np.int32)        # 2 full blocks + 2 tail
    r1 = _req(0, prompt)
    assert cache.alloc_prompt(r1)
    assert r1.pos == 0 and r1.skipped_prefill == 0
    r1.pos = 10                                    # prefill "ran"
    cache.register_prefix(r1)
    assert len(cache.prefix) == 2                  # only FULL prompt blocks
    shared = r1.blocks[:2]
    cache.release(r1)                              # index keeps its refs

    r2 = _req(1, prompt)
    assert cache.alloc_prompt(r2)
    assert r2.blocks[:2] == shared                 # adopted, not re-alloced
    assert r2.pos == r2.skipped_prefill == 8
    assert cache.allocator.refcount(shared[0]) == 2   # index + r2

    r3 = _req(2, np.concatenate([prompt[:4], 90 + np.arange(6)]))
    assert cache.alloc_prompt(r3)                  # diverges after block 0
    assert r3.blocks[0] == shared[0] and r3.blocks[1] != shared[1]
    assert r3.pos == 4
    assert cache.allocator.refcount(shared[0]) == 3
    cache.prefix.check()


def test_full_prompt_match_keeps_one_token_to_prefill(bnn_cfg):
    cache = _cache(bnn_cfg)
    prompt = np.arange(8, dtype=np.int32)          # exactly 2 blocks
    r1 = _req(0, prompt)
    cache.alloc_prompt(r1)
    r1.pos = 8
    cache.register_prefix(r1)
    cache.release(r1)
    r2 = _req(1, prompt)
    cache.alloc_prompt(r2)
    assert len(r2.blocks) == 2 and r2.pos == 7
    assert list(cache.writable_indices(7, 1)) == [1]


def test_cow_never_mutates_a_shared_block(bnn_cfg):
    cache = _cache(bnn_cfg)
    r1, r2 = _req(0, np.arange(4)), _req(1, np.arange(4))
    r1.blocks = cache.allocator.alloc(1)
    cache.allocator.incref(r1.blocks[0])
    r2.blocks = list(r1.blocks)                    # shared (refcount 2)
    shared = r1.blocks[0]
    cache.pools[0]["k"][shared] = 7.0
    assert cache.make_writable(r2, 0)
    assert r2.blocks[0] != shared and r1.blocks[0] == shared
    assert cache.allocator.refcount(shared) == 1
    assert cache.cow_copies == 1
    for pool in cache.pools:                       # the copy carries content
        for v in pool.values():
            torch.testing.assert_close(v[r2.blocks[0]], v[shared],
                                       rtol=0, atol=0)
    cache.pools[0]["k"][r2.blocks[0]] = -1.0       # writes stay private
    assert bool((cache.pools[0]["k"][shared] == 7.0).all())
    assert cache.make_writable(r1, 0) and r1.blocks[0] == shared
    assert cache.cow_copies == 1


def test_prefix_eviction_under_pressure(bnn_cfg):
    cache = _cache(bnn_cfg, num_blocks=5)          # 4 allocatable
    r1 = _req(0, np.arange(8, dtype=np.int32))
    cache.alloc_prompt(r1)
    r1.pos = 8
    cache.register_prefix(r1)
    cache.release(r1)                              # blocks live on, cached
    assert cache.allocator.num_used == 2
    r2 = _req(1, 50 + np.arange(16, dtype=np.int32))
    assert cache.alloc_prompt(r2)                  # evicts the cached pair
    assert cache.prefix.evictions == 2 and len(cache.prefix) == 0
    assert cache.allocator.num_used == 4
    cache.allocator.check()
    cache.prefix.check()


def _fill(cache, ids, seed):
    gen = torch.Generator().manual_seed(seed)
    for pool in cache.pools:
        for v in pool.values():
            v[ids] = torch.randn(v[ids].shape, generator=gen)


@pytest.mark.parametrize("registered", [0, 1])
def test_swap_round_trip_restores_block_bytes(bnn_cfg, registered):
    """Swap out, let another request take and overwrite the freed
    blocks, swap back in: the restored blocks hold the swapped bytes;
    registered blocks skip the host trip and are re-adopted."""
    cache = _cache(bnn_cfg, num_blocks=5)
    r = _req(0, np.arange(12, dtype=np.int32))
    assert cache.alloc_prompt(r)
    ids = torch.tensor(r.blocks)
    _fill(cache, ids, 1)
    want = [{k: v[ids].clone() for k, v in pool.items()}
            for pool in cache.pools]
    r.pos = 4 * registered
    cache.register_prefix(r)
    r.pos = 12
    cache.swap_out(r)
    assert r.blocks == [] and r.swap_readopt == registered
    assert cache.allocator.num_used == registered  # the index keeps them
    assert cache.swapped_blocks == 3 - registered
    assert cache.swap_out_bytes == sum(
        v[0].numel() * 4 for p in cache.pools for v in p.values()) \
        * (3 - registered)
    other = _req(1, 40 + np.arange(4 * (4 - registered), dtype=np.int32))
    assert cache.alloc_prompt(other)               # takes the freed blocks
    _fill(cache, torch.tensor(other.blocks), 2)
    cache.release(other)
    assert cache.swap_in(r) is True
    assert len(r.blocks) == 3 and r.host_kv is None
    assert cache.readopted_blocks == registered
    for pool, w in zip(cache.pools, want):
        for k, v in pool.items():
            torch.testing.assert_close(v[torch.tensor(r.blocks)], w[k],
                                       rtol=0, atol=0)
    cache.allocator.check()


def test_swap_in_reports_a_lost_chain(bnn_cfg):
    cache = _cache(bnn_cfg)
    r = _req(0, np.arange(9, dtype=np.int32))
    assert cache.alloc_prompt(r)
    r.pos = 9
    cache.register_prefix(r)
    cache.swap_out(r)
    assert r.swap_readopt == 2
    cache.prefix.evict(cache.allocator, len(cache.prefix))
    used = cache.allocator.num_used
    assert cache.swap_in(r) is None                # content gone
    assert cache.allocator.num_used == used        # nothing leaked
    cache.allocator.check()


def test_cache_bookkeeping_matches_jax(bnn_cfg):
    """The same admissions, registrations, copy-on-write, eviction and
    swaps on both packages' caches leave the same block ids, positions
    and counters."""
    jcfg = F.cfgs(ARCH, "bnn")[0]
    kw = dict(num_blocks=9, block_size=4, max_model_len=32)
    caches = (JCache(jcfg, **kw), BlockKVCache(bnn_cfg, **kw))
    base = np.arange(12, dtype=np.int32)
    prompts = [base, base[:8], np.concatenate([base[:4], 70 + base]), base]
    seen = []
    for cache, R in zip(caches, (JRequest, Request)):
        reqs = [R(i, p, 4) for i, p in enumerate(prompts)]
        log = []
        for r in reqs[:3]:
            ok = cache.alloc_prompt(r)
            log.append((ok, r.pos, list(r.blocks)))
            if ok:
                r.pos = r.prompt_len
                cache.register_prefix(r)
                log.append(cache.make_writable(r, 0))
        cache.swap_out(reqs[0])
        cache.release(reqs[1])
        log.append(cache.alloc_prompt(reqs[3]))
        log.append((reqs[3].pos, list(reqs[3].blocks)))
        log.append(cache.swap_in(reqs[0]))
        log.append(list(reqs[0].blocks))
        log.append((cache.prefix_queries, cache.prefix_hits,
                    cache.skipped_prefill_tokens, cache.cow_copies,
                    cache.swap_outs, cache.swap_ins, cache.swapped_blocks,
                    cache.readopted_blocks, cache.prefix.evictions,
                    len(cache.prefix), cache.allocator.num_used))
        seen.append(log)
    assert seen[1] == seen[0]


# --------------------------------------------------------- engine level

@pytest.fixture(scope="module", params=sorted(F.PREFIX_FAMILIES))
def family(request):
    arch = request.param
    kw, shared, tails, gen = F.PREFIX_FAMILIES[arch]
    jp, tp = F.models(arch)
    jcfg, tcfg = F.cfgs(arch, "bnn")
    arrival, prompts = F.poisson_trace(jcfg.vocab, shared, tails)
    je = JEngine(jp, jcfg, JEngineConfig(**kw, attn_impl="xla",
                                         bnn_impl="xla"))
    te = Engine(tp, tcfg, EngineConfig(**kw), device="cpu")
    runs = {"jax": (je, F.drive_trace(je, arrival, prompts, gen)),
            "torch": (te, F.drive_trace(te, arrival, prompts, gen))}
    calm = Engine(tp, tcfg, EngineConfig(
        **{**kw, "num_blocks": 65}, prefix_cache=False,
        preempt_policy="recompute"), device="cpu")
    runs["calm"] = (calm, F.drive_trace(calm, arrival, prompts, gen))
    return arch, runs


def _counts(section):
    return {k: v for k, v in section.items()
            if not k.endswith("_s") and k != "swap_out_bytes"}


def test_engine_tokens_and_counts_match_jax(family):
    arch, runs = family
    (je, jout), (te, tout) = runs["jax"], runs["torch"]
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b, a)
    js_, ts_ = je.stats(), te.stats()
    for sec in ("prefix_cache", "swap"):
        assert _counts(ts_[sec]) == _counts(js_[sec]), sec
    assert ts_["preemptions"] == js_["preemptions"]
    # the trace exercised every mechanism the config has
    assert ts_["prefix_cache"]["hits"] > 0
    assert ts_["prefix_cache"]["cow_copies"] > 0     # the whole repeat
    assert ts_["swap"]["swap_outs"] > 0 and ts_["swap"]["swap_ins"] > 0
    assert ts_["swap"]["swap_out_bytes"] > 0
    if arch == "mixtral-8x7b":
        assert ts_["mixer"]["blocks"]["layout"] == "ring"
    # the same decisions in the same order
    ev = ("admit", "swap_out", "swap_in", "swap_lost", "evict", "prefill",
          "first_token", "finish")
    assert [(e["step"], e["event"], e["rid"]) for e in te.scheduler.trace
            if e["event"] in ev] == \
        [(e["step"], e["event"], e["rid"]) for e in je.scheduler.trace
         if e["event"] in ev]
    te.cache.attn.allocator.check()
    te.cache.prefix.check()


def test_prefix_cache_and_swap_change_no_token(family):
    _arch, runs = family
    for a, b in zip(runs["torch"][1], runs["calm"][1]):
        np.testing.assert_array_equal(a, b)
    assert runs["calm"][0].stats()["preemptions"] == 0


def _swap_mid_prefill(tcfg, tp):
    """One request swapped out after registering two full prompt
    blocks (bs 2, prompt 7 -> pos 4 registered)."""
    eng = Engine(tp, tcfg, EngineConfig(block_size=2, num_blocks=33,
                                        max_batch=2, max_model_len=16,
                                        prefill_chunk=4), device="cpu")
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab, 7)
    rid = eng.submit(prompt, 5)
    eng.step()
    req = eng.requests[rid]
    assert req.pos == 4 and req.n_registered == 2
    eng.scheduler._preempt_one(eng.step_count, None)
    assert req.state == State.SWAPPED and req.swap_readopt == 2
    return eng, rid, prompt


@pytest.fixture(scope="module")
def bnn_models():
    return F.models(ARCH)


def _calm(tcfg, tp, prompt):
    eng = Engine(tp, tcfg, EngineConfig(max_model_len=16), device="cpu")
    rid = eng.submit(prompt, 5)
    return eng.run()[rid]


def test_swap_in_readopts_index_resident_blocks(bnn_models):
    tcfg = F.cfgs(ARCH, "bnn")[1]
    eng, rid, prompt = _swap_mid_prefill(tcfg, bnn_models[1])
    out = eng.run()
    sw = eng.stats()["swap"]
    assert sw["readopted_blocks"] == 2 and sw["swapped_blocks"] == 2
    np.testing.assert_array_equal(out[rid], _calm(tcfg, bnn_models[1],
                                                  prompt))


def test_swap_lost_falls_back_to_recompute(bnn_models):
    tcfg = F.cfgs(ARCH, "bnn")[1]
    eng, rid, prompt = _swap_mid_prefill(tcfg, bnn_models[1])
    attn = eng.cache.attn
    attn.prefix.evict(attn.allocator, len(attn.prefix))
    out = eng.run()
    assert any(e["event"] == "swap_lost" and e["rid"] == rid
               for e in eng.scheduler.trace)
    assert eng.scheduler.swap_losts == 1
    np.testing.assert_array_equal(out[rid], _calm(tcfg, bnn_models[1],
                                                  prompt))
    attn.allocator.check()


def test_cancel_drops_a_swapped_request(bnn_models):
    tcfg = F.cfgs(ARCH, "bnn")[1]
    eng, rid, _prompt = _swap_mid_prefill(tcfg, bnn_models[1])
    assert eng.cancel(rid)
    req = eng.requests[rid]
    assert req.state == State.CANCELLED and req.host_kv is None
    assert eng.run() == {}


def test_engine_defaults_equal_jax():
    """``EngineConfig()`` takes the JAX engine's defaults."""
    for name in ("prefix_cache", "preempt_policy", "snapshot_slots",
                 "block_size", "num_blocks", "max_batch", "prefill_chunk",
                 "max_model_len", "max_tokens_in_flight",
                 "max_batched_tokens", "policy", "spec_k", "spec_ngram",
                 "role",
                 "attn_impl", "bnn_impl"):
        assert getattr(EngineConfig(), name) == \
            getattr(JEngineConfig(), name), name
    with pytest.raises(NotImplementedError, match="one impl"):
        EngineConfig(attn_impl="torch", bnn_impl="auto")
    with pytest.raises(ValueError, match="preempt_policy"):
        EngineConfig(preempt_policy="drop")


def test_reset_stats_zeroes_counters_and_flushes_the_index(bnn_models):
    """``reset_stats(flush_prefix=True)`` zeroes the token, wall, prefix
    and swap counters and drops every idle cached block, as the JAX
    engine's does."""
    tcfg = F.cfgs(ARCH, "bnn")[1]
    eng, _rid, _prompt = _swap_mid_prefill(tcfg, bnn_models[1])
    eng.run()
    before = eng.stats()
    assert before["prefix_cache"]["cached_blocks"] > 0
    assert before["swap"]["swap_outs"] == 1 and before["decoded_tokens"] > 0
    eng.reset_stats(flush_prefix=True)
    st = eng.stats()
    pc, sw = st["prefix_cache"], st["swap"]
    assert pc["cached_blocks"] == pc["hits"] == pc["queries"] == 0
    assert pc["evictions"] == pc["skipped_prefill_tokens"] == 0
    assert sw["swap_outs"] == sw["swap_ins"] == sw["swapped_blocks"] == 0
    assert sw["swap_out_s"] == sw["swap_in_s"] == 0.0
    assert st["decoded_tokens"] == st["prefill_tokens"] == 0
    assert st["wall_s"] == 0.0
    assert eng.cache.attn.allocator.num_used == 0
    eng.cache.attn.allocator.check()
