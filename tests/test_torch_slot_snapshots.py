"""Recurrent-state prefix caching of the port against the JAX package
(the properties of tests/test_slot_snapshots.py, across the two
packages), on the reduced mamba2.

Index level: ``SlotSnapshotIndex`` recycles its rows in LRU order, keeps
a duplicate key's row and flushes as the JAX index does; a restore
reproduces the stored state bit for bit; ``match_prefix`` finds the
deepest standalone entry, capped at prompt_len - 1 and at a hybrid's
``limit``, with JAX's keys and depths.

Engine level, under the prefix cache (snapshot_slots = 2 x max_batch):
a shared head's snapshot skips prefill (greedy and sampled), a
single-row pool recycles, and no snapshot is taken off the chunk grid.
In each, the port's tokens, prefix-cache / swap counts, mixer section
and scheduler events equal the JAX engine's on the same requests, and
its tokens equal the same requests served without the prefix cache.
Swap and preemption: tests/test_torch_slot_swap.py; the jamba hybrid's
joint match: tests/test_torch_hybrid_snapshots.py.

The JAX side runs its XLA paths, the port its plain kernel versions on
the CPU; every comparison here is exact."""
import jax
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.serving import SlotSnapshotIndex as JIndex
from repro.serving.mixer_state import RecurrentSlotState as JSlots
from repro_torch.layers import mamba2
from repro_torch.serving import Engine, EngineConfig, Request, SamplingParams
from repro_torch.serving.mixer_state import (RecurrentSlotState,
                                             SlotSnapshotIndex, chunk_key)

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
ENGINE = dict(block_size=4, num_blocks=33, max_batch=4, prefill_chunk=4,
              max_model_len=32)


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


@pytest.fixture(scope="module")
def tcfg():
    return F.cfgs(ARCH, "bnn")[1]


def _keys(prompt, bs, n):
    """Chain keys of the first n full blocks of prompt."""
    parent, out = "", []
    for j in range(n):
        parent = chunk_key(parent, np.asarray(prompt[j * bs:(j + 1) * bs],
                                              np.int32))
        out.append(parent)
    return out


def shared_prompts(vocab, seed=0, head=8, tails=(3, 2)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, head)
    return [np.concatenate([shared, rng.integers(0, vocab, t)])
            .astype(np.int32) for t in tails]


def run_one_by_one(eng, prompts, gen=6, sampling=None):
    """Submit and finish each prompt in turn (the next sees the first's
    snapshots); (outputs, prefill chunks per request)."""
    outs, chunks = [], []
    for p in prompts:
        rid = eng.submit(p, gen, sampling=sampling)
        outs.append(eng.run()[rid])
        chunks.append(sum(1 for e in eng.scheduler.trace
                          if e["event"] == "prefill" and e["rid"] == rid))
    return outs, chunks


# ----------------------------------------------------------- index level


def _live(cfg_j, cfg_t, rows=3):
    """Equal live pools for both packages (2 layers), every slot a
    different value."""
    rng = np.random.default_rng(1)
    pools_t = [mamba2.init_paged_state(cfg_t, rows) for _ in range(2)]
    for pool in pools_t:
        for v in pool.values():
            v.copy_(torch.from_numpy(rng.normal(size=v.shape)
                                     .astype(np.float32)))
    pools_j = [{k: jax.numpy.asarray(v.numpy()) for k, v in p.items()}
               for p in pools_t]
    return pools_j, pools_t


def test_snapshot_index_lru_dedup_and_recycling(tcfg):
    jcfg = F.cfgs(ARCH, "bnn")[0]
    live_j, live_t = _live(jcfg, tcfg)
    ji, ti = JIndex(jcfg, 2, 2), SlotSnapshotIndex(tcfg, 2, 2)
    ops = [("store", "a", 1), ("store", "a", 2), ("store", "b", 2),
           ("lookup", "a", None), ("store", "c", 1), ("lookup", "b", None),
           ("store", "b", 0)]
    for op, key, slot in ops:
        if op == "store":
            assert ti.store(key, live_t, slot) == ji.store(key, live_j, slot)
        else:
            assert ti.lookup(key) == ji.lookup(key)
        assert (len(ti), ti.stores, ti.evictions, ti.peak_used) == \
            (len(ji), ji.stores, ji.evictions, ji.peak_used)
        assert list(ti._map.items()) == list(ji._map.items())
    # every row holds its slot's bits (a, stored from slot 1, was dropped
    # for b, stored from slot 0)
    assert dict(ti._map) == {"c": ti._map["c"], "b": ti._map["b"]}
    for key, slot in (("c", 1), ("b", 0)):
        row = ti._map[key]
        for li in range(2):
            for k in ("h", "conv"):
                assert torch.equal(ti.pools[li][k][row], live_t[li][k][slot])
                np.testing.assert_array_equal(
                    np.asarray(ji.pools[li][k][row]), live_t[li][k][slot])
    ti.flush()
    ji.flush()
    assert len(ti) == 0 and sorted(ti._free) == sorted(ji._free) == [0, 1]
    with pytest.raises(ValueError):
        SlotSnapshotIndex(tcfg, 2, 0)


def test_snapshot_restore_reproduces_stored_state(tcfg):
    """alloc_prompt restores the EXACT bits the snapshot captured, and a
    copy of them: writing the slot afterwards leaves the snapshot as it
    was."""
    st = RecurrentSlotState(tcfg, [0, 1], num_slots=4, block_size=4,
                            snapshot_slots=2)
    prompt = np.arange(9, dtype=np.int32)
    key = _keys(prompt, 4, 1)[0]
    for li in range(2):
        for v in st.pools[li].values():
            v[1] += 2.5 + li
    want = [{k: v[1].clone() for k, v in st.pools[li].items()}
            for li in range(2)]
    st.snapshots.store(key, st.pools, 1)
    for li in range(2):                    # the live slot moves on
        for v in st.pools[li].values():
            v[1] = -1.0
    r = Request(0, prompt, 4)
    match = st.match_prefix(prompt)
    assert match == (4, key, 2)
    assert st.alloc_prompt(r, match)
    assert r.pos == r.skipped_prefill == 4
    assert r.snap_registered == 1 and r.snap_key == key
    for li in range(2):
        for k, v in want[li].items():
            assert torch.equal(st.pools[li][k][r.slot], v)
        st.pools[li]["h"][r.slot] = 0.0
    row = st.snapshots.lookup(key)
    for li in range(2):
        assert torch.equal(st.snapshots.pools[li]["h"][row], want[li]["h"])
    assert st.snap_hits == 1 and st.skipped_prefill_tokens == 4
    assert st.snap_queries == 2


def test_match_prefix_standalone_depths_equal_jax(tcfg):
    jcfg = F.cfgs(ARCH, "bnn")[0]
    js_ = JSlots(jcfg, [0, 1], num_slots=4, block_size=4, snapshot_slots=4)
    ts_ = RecurrentSlotState(tcfg, [0, 1], num_slots=4, block_size=4,
                             snapshot_slots=4)
    prompt = np.arange(13, dtype=np.int32)
    k1, k2, k3 = _keys(prompt, 4, 3)

    def both(p, **kw):
        got = ts_.match_prefix(p, **kw)
        assert got == js_.match_prefix(p, **kw)
        return got

    assert both(prompt) == (0, "", 3)
    # a depth-2 entry matches with depth 1 missing: snapshots are
    # standalone whole-state captures
    for s in (ts_, js_):
        s.snapshots.store(k2, s.pools, 0)
    assert both(prompt) == (8, k2, 3)
    for s in (ts_, js_):
        s.snapshots.store(k3, s.pools, 0)
    assert both(prompt)[0] == 12                 # the deepest wins
    assert both(prompt, limit=9)[0] == 8         # a hybrid's cap
    assert both(prompt, limit=3)[0] == 0
    # a block-multiple prompt never adopts its full depth
    assert both(prompt[:12]) == (8, k2, 2)
    assert list(ts_.snapshots._map) == list(js_.snapshots._map)


# ---------------------------------------------------------- engine level


def _pair(models, prompts, gen=6, sampling=None, **kw):
    """Both packages' engines under ENGINE + kw, prompts one by one."""
    jp, tp = models
    je, te = F.engines(ARCH, jp, tp, **{**ENGINE, **kw})
    (jout, jch), (tout, tch) = (run_one_by_one(e, prompts, gen, sampling)
                                for e in (je, te))
    F.check_same_engine(je, jout, te, tout)
    assert tch == jch
    return te, tout, tch


def _off(models, prompts, gen=6, sampling=None, **kw):
    """The port's engine on the same prompts without the prefix cache."""
    tcfg = F.cfgs(ARCH, "bnn")[1]
    eng = Engine(models[1], tcfg, EngineConfig(**{**ENGINE, **kw},
                                               prefix_cache=False),
                 device="cpu")
    return run_one_by_one(eng, prompts, gen, sampling)[0]


@pytest.mark.parametrize("sampled", [False, True])
def test_snapshot_hit_skips_prefill(models, sampled):
    """A request sharing a 2-block prompt head skips the head's prefill
    chunks, reports snapshot hits and skipped tokens, and its tokens
    (greedy and sampled) equal a run without the prefix cache."""
    prompts = shared_prompts(128)
    sampling = (SamplingParams(temperature=0.8, top_k=24, seed=7)
                if sampled else None)
    on, got, chunks = _pair(models, prompts, sampling=sampling)
    st = on.stats()["prefix_cache"]
    assert st["enabled"] and st["snapshot_hits"] == 2
    assert st["skipped_prefill_tokens"] == 8
    assert st["snapshot_stores"] >= 2 and st["hit_rate"] > 0
    assert chunks == [3, 1]
    for a, b in zip(got, _off(models, prompts, sampling=sampling)):
        np.testing.assert_array_equal(a, b)
    slots = on.stats()["mixer"]["slots"]
    assert slots["snapshot_slots"] == 2 * ENGINE["max_batch"]
    assert slots["cached_snapshots"] >= 2
    assert 0 < slots["snapshot_occupancy"] <= 1


def test_snapshot_pool_capacity_recycles_lru(models):
    """A single-row snapshot pool keeps only the latest capture: depth 1
    gives way to depth 2, the match still finds it, tokens unchanged."""
    prompts = shared_prompts(128, seed=7)
    on, got, _ = _pair(models, prompts, snapshot_slots=1)
    st = on.stats()["prefix_cache"]
    assert st["snapshot_evictions"] >= 1
    assert st["skipped_prefill_tokens"] == 8
    for a, b in zip(got, _off(models, prompts)):
        np.testing.assert_array_equal(a, b)


def test_no_snapshot_off_the_chunk_grid(models):
    """Prompt 12, chunk 8, block 4: chunks end at 8 and 12, and only 8
    is on the chunk grid, so only depth 8 is captured; the second prompt
    resumes there."""
    rng = np.random.default_rng(8)
    head = rng.integers(0, 128, 12)
    prompts = [head.astype(np.int32),
               np.concatenate([head, rng.integers(0, 128, 4)])
               .astype(np.int32)]
    kw = dict(prefill_chunk=8, block_size=4, max_model_len=32)
    on, got, _ = _pair(models, prompts, gen=4, **kw)
    snaps = on.cache.ssm.snapshots
    k8, k12 = _keys(prompts[0], 4, 3)[1:]
    k16 = _keys(prompts[1], 4, 4)[3]       # the second prompt's end
    assert k8 in snaps and k12 not in snaps and k16 in snaps
    assert len(snaps) == 2
    r2 = max(on.requests)
    assert on.requests[r2].skipped_prefill == 8
    for a, b in zip(got, _off(models, prompts, gen=4, **kw)):
        np.testing.assert_array_equal(a, b)
