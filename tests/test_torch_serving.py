"""Port serving engine: allocator invariants (the JAX suite's cases),
and the port's Engine against the JAX Engine on the same weights —
identical greedy tokens under continuous batching with mid-stream
admission and under recompute preemption — plus stop tokens, the
slice's refused options, cancellation and streaming.

Both engines run fcfs, mixed role, no prefix cache, recompute
preemption, greedy (the prefix cache, swap and sampling are held to
JAX in tests/test_torch_prefix_swap.py and
tests/test_torch_sampling.py); the JAX side runs its XLA
paths (``attn_impl="xla"``, ``bnn_impl="xla"``), the port its plain
kernel versions on the CPU."""
import random

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tiny deterministic fallback (tests/_hypothesis_shim.py)
    from _hypothesis_shim import given, settings, strategies as st

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.models import transformer as JM
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.interop import params_from_numpy
from repro_torch.serving import (BlockAllocator, Engine, EngineConfig,
                                 SamplingParams, State)

torch.set_num_threads(1)

# ------------------------------------------------------------- allocator


def test_block_allocator_invariants():
    a = BlockAllocator(9)           # 1 scratch + 8 allocatable
    assert a.capacity == 8 and a.num_free == 8
    x = a.alloc(3)
    y = a.alloc(5)
    assert a.alloc(1) is None       # exhausted: all-or-nothing
    ids = x + y
    assert len(set(ids)) == 8       # distinct
    assert 0 not in ids             # scratch block never handed out
    a.free(x)
    assert a.num_free == 3 and a.num_used == 5
    with pytest.raises(ValueError):
        a.free(x)                   # double free detected
    z = a.alloc(3)                  # freed blocks recycled, no leak
    assert sorted(z) == sorted(x)
    a.free(y)
    a.free(z)
    assert a.num_free == 8 and a.num_used == 0


def test_block_allocator_fragmentation_free_reuse():
    a = BlockAllocator(17)
    held = []
    for i in range(50):
        got = a.alloc(1 + i % 3)
        assert got is not None
        held.append(got)
        if len(held) > 3:
            a.free(held.pop(0))
    for h in held:
        a.free(h)
    assert a.num_free == a.capacity


@settings(max_examples=25, deadline=None)
@given(st.integers(2, 48), st.integers(0, 2 ** 31 - 1))
def test_random_interleavings_never_leak_or_double_free(num_blocks, seed):
    rng = random.Random(seed)
    a = BlockAllocator(num_blocks)
    model: dict[int, int] = {}
    owners: list[list[int]] = []
    for _ in range(120):
        op = rng.choice(["alloc", "alloc", "share", "free"])
        if op == "alloc":
            n = rng.randint(0, a.capacity + 2)
            before = a.num_free
            got = a.alloc(n)
            if n > before:
                assert got is None and a.num_free == before
            else:
                assert got is not None and len(got) == len(set(got)) == n
                assert 0 not in got
                for b in got:
                    assert b not in model
                    model[b] = 1
                owners.append(got)
        elif op == "share" and owners:
            src = rng.choice(owners)
            for b in src:
                a.incref(b)
                model[b] += 1
            owners.append(list(src))
        elif op == "free" and owners:
            victim = owners.pop(rng.randrange(len(owners)))
            a.free(victim)
            for b in victim:
                model[b] -= 1
                if model[b] == 0:
                    del model[b]
        a.check()
        assert a.num_used == len(model)
        for b in range(1, a.num_blocks):
            assert a.refcount(b) == model.get(b, 0)
    for o in owners:
        a.free(o)
    assert a.num_free == a.capacity and a.num_used == 0


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_scratch_block_never_circulates(seed):
    rng = random.Random(seed)
    a = BlockAllocator(rng.randint(2, 64))
    seen = set()
    while (got := a.alloc(rng.randint(1, max(1, a.num_free or 1)))):
        seen.update(got)
        if a.num_free == 0:
            break
    assert 0 not in seen and len(seen) == a.capacity
    with pytest.raises(ValueError):
        a.free([0])


# --------------------------------------------------------- engine parity

SLICE = dict(block_size=4, num_blocks=33, max_batch=4, prefill_chunk=4,
             max_model_len=32)
PRESSURE = dict(block_size=2, num_blocks=9, max_batch=2, prefill_chunk=4,
                max_model_len=12)


@pytest.fixture(scope="session")
def models():
    jcfg = jreduced(jconfigs.get_config("bnn-lm-100m")).replace(precision="bnn")
    tcfg = treduced(tconfigs.get_config("bnn-lm-100m")).replace(precision="bnn")
    jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _drive(eng, prompts, max_new, late: int, late_after: int):
    """Submit all but the last ``late`` prompts, step ``late_after``
    times, submit the rest mid-stream, run to completion."""
    early = len(prompts) - late
    rids = [eng.submit(p, n) for p, n in zip(prompts[:early], max_new)]
    for _ in range(late_after):
        eng.step()
    rids += [eng.submit(p, n) for p, n in zip(prompts[early:], max_new[early:])]
    return rids, eng.run()


def _pair(models, ecfg_kw, prompts, max_new, late=0, late_after=0):
    jcfg, jp, tcfg, tp = models
    je = JEngine(jp, jcfg, JEngineConfig(
        **ecfg_kw, prefix_cache=False, preempt_policy="recompute",
        attn_impl="xla", bnn_impl="xla"))
    te = Engine(tp, tcfg, EngineConfig(
        **ecfg_kw, prefix_cache=False, preempt_policy="recompute"),
        device="cpu")
    j = _drive(je, prompts, max_new, late, late_after)
    t = _drive(te, prompts, max_new, late, late_after)
    return (je, j), (te, t)


@pytest.fixture(scope="session")
def continuous_run(models):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n) for n in (3, 6, 9, 5)]
    return _pair(models, SLICE, prompts, [10, 8, 6, 9], late=2,
                 late_after=5)


@pytest.fixture(scope="session")
def pressure_run(models):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, 4) for _ in range(2)]
    return _pair(models, PRESSURE, prompts, [8, 8])


def test_engine_matches_jax_with_mid_stream_admission(continuous_run):
    (je, (jrids, jout)), (te, (trids, tout)) = continuous_run
    assert trids == jrids and sorted(tout) == sorted(jout) == jrids
    for rid in jrids:
        np.testing.assert_array_equal(tout[rid], jout[rid])
    # continuous batching engaged: the late pair was admitted mid-stream
    # and decoded next to the early pair
    trace = te.scheduler.trace
    late = trids[2:]
    assert all(next(e for e in trace if e["event"] == "admit"
                    and e["rid"] == r)["step"] >= 5 for r in late)
    assert te.stats()["max_concurrent_decode"] >= 2
    assert any(len(e["rids"]) >= 2 for e in trace if e["event"] == "decode")
    assert te.stats()["finished"] == 4
    assert te.cache.attn.allocator.num_used == 0     # every block returned


def test_engine_matches_jax_under_recompute_preemption(pressure_run):
    (je, (jrids, jout)), (te, (trids, tout)) = pressure_run
    assert any(e["event"] == "evict" for e in te.scheduler.trace)
    assert te.stats()["preemptions"] >= 1
    for rid in jrids:
        np.testing.assert_array_equal(tout[rid], jout[rid])
    te.cache.attn.allocator.check()
    assert te.cache.attn.allocator.num_used == 0


def test_stop_token_ends_request_and_frees_blocks(models, continuous_run):
    """The stop token is one whose FIRST occurrence in the JAX engine's
    plain greedy output is at index j > 0: the request ends with exactly
    j+1 tokens, equal to that output's head, and its blocks are free."""
    (_je, (jrids, jout)), _ = continuous_run
    _jcfg, _jp, tcfg, tp = models
    rid = jrids[0]
    prompt_len = 3
    gen = list(jout[rid][prompt_len:])
    firsts = [j for j in range(1, len(gen) - 1) if gen.index(gen[j]) == j]
    assert firsts, f"no token first occurs past index 0 in {gen}"
    j = firsts[-1]
    eng = Engine(tp, tcfg, EngineConfig(**SLICE), device="cpu")
    r = eng.submit(jout[rid][:prompt_len], len(gen),
                   sampling=SamplingParams(stop=(gen[j],)))
    out = eng.run()
    assert list(out[r][prompt_len:]) == gen[:j + 1]
    assert eng.requests[r].state == State.FINISHED
    assert eng.requests[r].blocks == []
    assert eng.cache.attn.allocator.num_used == 0


def test_commit_stream_and_cancel(models, continuous_run):
    """The commit callback streams exactly run()'s tokens; cancelling a
    running request frees its blocks and leaves the others intact."""
    (_je, (jrids, jout)), _ = continuous_run
    _jcfg, _jp, tcfg, tp = models
    eng = Engine(tp, tcfg, EngineConfig(**SLICE), device="cpu")
    streamed: dict[int, list[int]] = {}
    eng.set_commit_callback(
        lambda rid, toks, done: streamed.setdefault(rid, []).extend(toks))
    a = eng.submit(jout[jrids[0]][:3], 10)
    b = eng.submit(jout[jrids[1]][:6], 8)
    for _ in range(4):
        eng.step()
    assert eng.cancel(b) and not eng.cancel(b)
    assert eng.requests[b].state == State.CANCELLED
    out = eng.run()
    assert sorted(out) == [a]
    np.testing.assert_array_equal(out[a], jout[jrids[0]])
    assert streamed[a] == list(out[a][3:])
    # only the prefix index's cached blocks stay, one reference each
    attn = eng.cache.attn
    assert attn.allocator.num_used == len(attn.prefix)
    assert all(attn.allocator.refcount(b) == 1
               for b in range(1, attn.allocator.num_blocks)
               if attn.allocator.refcount(b))


@pytest.mark.parametrize("option", [dict(role="prefill"), dict(role="decode")])
def test_unported_engine_options_raise(option):
    """The worker roles, refused until they were ported, are taken now;
    a role the JAX package does not know raises as its ``get_role``."""
    assert EngineConfig(**option).role == option["role"]
    with pytest.raises(ValueError, match="unknown role"):
        EngineConfig(role=option["role"] + "x")


def test_engine_rejects_oversized_request(models):
    _jcfg, _jp, tcfg, tp = models
    eng = Engine(tp, tcfg, EngineConfig(block_size=2, num_blocks=5,
                                        max_model_len=32), device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.zeros(16, np.int32), 16)   # > whole block pool
