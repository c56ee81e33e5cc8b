"""Swap and preemption of the port's recurrent slots against the JAX
package (the swap properties of tests/test_slot_snapshots.py, across the
two packages), on the reduced mamba2 under the prefix cache.

A request parked exactly at a registered snapshot skips the host trip
and is re-adopted by hash at swap-in; if the snapshot was evicted while
it was parked, swap-in reports it lost and the request is recomputed
(``swap_lost``); one parked mid-decode, or at a snapshot already
evicted, takes the host trip and its slot comes back bit-equal; a
forced preemption gives the same tokens with the snapshots on and off,
greedy and sampled.  In each, the port's tokens, prefix-cache / swap
counts, preemptions and scheduler events equal the JAX engine's, and
its tokens equal a run without pressure.

The JAX side runs its XLA paths, the port its plain kernel versions on
the CPU; every comparison here is exact."""
import numpy as np
import pytest
import torch

import _torch_family as F
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from test_torch_slot_snapshots import ENGINE, shared_prompts

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


def _both(models, drive, **kw):
    """``drive(engine)`` on both packages' engines (ENGINE + kw, swap
    preemption); the port's engine and outputs after the comparison."""
    je, te = F.engines(ARCH, *models, **{**ENGINE, **kw})
    jout, tout = drive(je), drive(te)
    F.check_same_engine(je, jout, te, tout)
    te.cache.ssm.allocator.check()
    return te, tout


def _calm(models, prompts, gen, sampling=None):
    """The port's tokens without pressure and without the prefix cache."""
    tcfg = F.cfgs(ARCH, "bnn")[1]
    eng = Engine(models[1], tcfg, EngineConfig(**ENGINE, prefix_cache=False),
                 device="cpu")
    rids = [eng.submit(p, gen, sampling=sampling) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def _swap_mid_prefill(prompt, before_park=None, while_parked=None):
    """One request swapped out right after its first chunk (pos 4, one
    full block: the parked state is a registered snapshot)."""
    def drive(eng):
        rid = eng.submit(prompt, 5)
        eng.step()
        req = eng.requests[rid]
        assert req.pos == 4 and req.snap_registered == 1
        if before_park:
            before_park(eng)
        eng.scheduler._preempt_one(eng.step_count, None)
        assert req.state.value == "swapped"
        if while_parked:
            while_parked(eng)
        return [eng.run()[rid]]
    return drive


def _flush(eng):
    eng.cache.ssm.snapshots.flush()


def test_swap_in_readopts_registered_snapshot(models):
    prompt = shared_prompts(128, seed=3)[0]

    def parked(eng):
        req = next(iter(eng.requests.values()))
        assert req.snap_readopt and req.host_state is None
    te, out = _both(models, _swap_mid_prefill(prompt, while_parked=parked))
    sw = te.stats()["swap"]
    assert sw["readopted_snapshots"] == 1 and sw["swapped_slots"] == 0
    assert sw["swap_outs"] == sw["swap_ins"] == 1
    np.testing.assert_array_equal(out[0], _calm(models, [prompt], 5)[0])


def test_snapshot_lost_falls_back_to_recompute(models):
    prompt = shared_prompts(128, seed=4)[0]
    te, out = _both(models, _swap_mid_prefill(prompt, while_parked=_flush))
    assert te.scheduler.swap_losts == 1
    assert any(e["event"] == "swap_lost" for e in te.scheduler.trace)
    np.testing.assert_array_equal(out[0], _calm(models, [prompt], 5)[0])


def test_swap_out_of_evicted_snapshot_takes_host_trip(models):
    """A snapshot recycled before the park is not re-adoptable: the slot
    takes the host trip (far cheaper than the recompute a swap_lost
    would cost)."""
    prompt = shared_prompts(128, seed=9)[0]

    def parked(eng):
        req = next(iter(eng.requests.values()))
        assert not req.snap_readopt and req.host_state is not None
    te, out = _both(models, _swap_mid_prefill(prompt, before_park=_flush,
                                              while_parked=parked))
    assert not any(e["event"] == "swap_lost" for e in te.scheduler.trace)
    assert te.stats()["swap"]["swapped_slots"] == 1
    np.testing.assert_array_equal(out[0], _calm(models, [prompt], 5)[0])


def test_mid_decode_swap_takes_host_trip_bit_equal(models):
    """Past the prompt the live state is no registered snapshot: the slot
    goes to the host and comes back with the same bytes."""
    prompt = shared_prompts(128, seed=5)[0]
    saved = {}

    def drive(eng):
        rid = eng.submit(prompt, 6)
        for _ in range(6):
            eng.step()
        req = eng.requests[rid]
        assert req.state.value == "decode" and req.pos > req.prompt_len
        if isinstance(eng, Engine):
            ssm = eng.cache.ssm
            saved["slot"] = [{k: v[req.slot].clone() for k, v in p.items()}
                             for p in ssm.pools]
            swap_in = ssm.swap_in

            def check(r):
                ok = swap_in(r)
                for p, want in zip(ssm.pools, saved["slot"]):
                    for k, v in want.items():
                        assert torch.equal(p[k][r.slot], v)
                saved["checked"] = True
                return ok
            ssm.swap_in = check
        eng.scheduler._preempt_one(eng.step_count, None)
        assert req.host_state is not None and not req.snap_readopt
        return [eng.run()[rid]]

    te, out = _both(models, drive)
    assert saved["checked"]
    sw = te.stats()["swap"]
    assert sw["swapped_slots"] == 1 and sw["swap_out_bytes"] > 0
    np.testing.assert_array_equal(out[0], _calm(models, [prompt], 6)[0])


@pytest.mark.parametrize("sampled", [False, True])
def test_forced_preempt_snapshots_on_equals_off(models, sampled):
    prompts = shared_prompts(128, seed=6)
    sampling = SamplingParams(temperature=0.9, seed=11) if sampled else None

    def drive(eng):
        rids = [eng.submit(p, 6, sampling=sampling) for p in prompts]
        for _ in range(5):                     # both mid-flight
            eng.step()
        eng.scheduler._preempt_one(eng.step_count, None)
        out = eng.run()
        return [out[r] for r in rids]

    te, out = _both(models, drive, max_batch=2)
    assert te.stats()["preemptions"] >= 1
    assert te.stats()["prefix_cache"]["snapshot_stores"] > 0
    off = Engine(models[1], F.cfgs(ARCH, "bnn")[1],
                 EngineConfig(**{**ENGINE, "max_batch": 2},
                              prefix_cache=False), device="cpu")
    for a, b in zip(out, drive(off)):
        np.testing.assert_array_equal(a, b)


def test_poisson_trace_under_the_defaults_matches_jax(models):
    """The Poisson trace of tests/test_torch_prefix_swap.py under
    ``EngineConfig`` defaults (the prefix cache, swap), 3 slots under a
    batch of 3, one request preempted mid-decode: tokens equal a run
    without either."""
    kw, shared, tails, gen = F.PREFIX_FAMILIES["bnn-lm-100m"]
    arrival, prompts = F.poisson_trace(128, shared, tails)

    def drive_all(eng):
        seqs, i = {}, 0
        while i < len(prompts) or not eng.scheduler.idle:
            while i < len(prompts) and eng.step_count >= arrival[i]:
                seqs[i] = eng.submit(prompts[i], gen)
                i += 1
            if eng.step_count == 9:
                eng.scheduler._preempt_one(eng.step_count, None)
            eng.step()
        return [eng.requests[seqs[k]].full_sequence()
                for k in range(len(prompts))]

    te, out = _both(models, drive_all, **kw)
    st = te.stats()
    assert st["prefix_cache"]["snapshot_hits"] > 0
    assert st["swap"]["swap_outs"] >= 1
    tcfg = F.cfgs(ARCH, "bnn")[1]
    calm = Engine(models[1], tcfg, EngineConfig(
        **kw, prefix_cache=False, preempt_policy="recompute"), device="cpu")
    for a, b in zip(out, F.drive_trace(calm, arrival, prompts, gen)):
        np.testing.assert_array_equal(a, b)
