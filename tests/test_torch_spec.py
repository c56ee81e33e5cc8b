"""Speculative decoding of the port against the JAX package (the
properties of tests/test_sampling_spec.py, across the two packages), on
the reduced bnn-lm-100m (paged GQA).

``prompt_lookup_draft`` proposes JAX's drafts on seeded sequences.
Through the engines, with ``spec_k`` 3: greedy and sampled speculative
tokens equal plain decoding's; an oracle drafter is accepted whole; a stop token mid-draft ends the
request there and clamps the accepted count; a draft never runs past
``max_new``; the scheduler charges ``spec_k + 1`` budget tokens a
decode row.  In each, the port's tokens, ``speculative`` stats (and the
prefix-cache, swap and photonic sections) and scheduler events,
``spec_decode`` steps included, equal the JAX engine's, and its tokens
equal plain decoding's.  Preemption and the ring:
tests/test_torch_spec_preempt.py; the other families:
tests/test_torch_spec_families.py.

The JAX side runs its XLA paths, the port its plain kernel versions on
the CPU; every comparison here is exact."""
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.serving import sampling as jsampling
from repro_torch.serving import SamplingParams
from repro_torch.serving import sampling as tsampling

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"
ENGINE = dict(block_size=4, num_blocks=33, max_batch=4, prefill_chunk=4,
              max_model_len=24)
SAMPLED = SamplingParams(temperature=0.8, top_k=24, top_p=0.95, seed=1234)


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


def periodic_prompt(rng, vocab, unit=3, reps=3):
    """Its final n-gram recurs, so prompt lookup always has a draft."""
    return np.tile(rng.integers(0, vocab, unit), reps)


def spec_vs_plain(arch, models, prompts, gen, sampling=None, drive=None,
                  change=None, jax_plain=False, **kw):
    """JAX's and the port's speculative engines and the port's plain
    engine on the same requests (``drive(engine)`` -> outputs, or submit
    all and run): the port equals JAX's speculative engine in
    everything, and its tokens equal plain decoding's (the port's plain
    engine is held to JAX's in tests/test_torch_serving.py and
    tests/test_torch_prefix_swap.py; ``jax_plain`` takes JAX's plain
    engine instead).  Returns the port's engine and outputs."""
    def submit_all(eng):
        rids = [eng.submit(p, gen, sampling=sampling) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids]
    drive = drive or submit_all
    jplain, plain = F.engines(arch, *models, change=change, **kw)
    want = drive(jplain if jax_plain else plain)
    je, te = F.engines(arch, *models, change=change, spec_k=3, **kw)
    jout, tout = drive(je), drive(te)
    F.check_same_engine(je, jout, te, tout)
    for w, g in zip(want, tout):
        np.testing.assert_array_equal(g, w)
    return te, tout


def test_prompt_lookup_draft_equals_jax():
    rng = np.random.default_rng(0)
    seqs = [np.array([5, 6, 7, 1, 2, 5, 6, 7, 9, 4, 5, 6, 7], np.int32),
            np.arange(8, dtype=np.int32),
            np.array([1, 2, 9, 8, 3, 2], np.int32), np.array([3], np.int32)]
    seqs += [rng.integers(0, v, n).astype(np.int32)
             for v, n in ((4, 30), (8, 20), (16, 40), (128, 64))]
    seqs += [periodic_prompt(rng, 128, u, r) for u, r in ((3, 3), (5, 4))]
    for seq in seqs:
        for k in (0, 1, 2, 4):
            for ngram in (1, 2, 3):
                got = tsampling.prompt_lookup_draft(seq, k, ngram)
                want = jsampling.prompt_lookup_draft(seq, k, ngram)
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsampling.prompt_lookup_draft(seqs[0], 4, 3), [9, 4, 5, 6])


@pytest.mark.parametrize("sampled", [False, True])
def test_spec_matches_plain_decoding(models, sampled):
    rng = np.random.default_rng(6)
    prompts = [periodic_prompt(rng, 128) for _ in range(2)]
    te, _ = spec_vs_plain(ARCH, models, prompts, 8,
                          SAMPLED if sampled else None, **ENGINE)
    sp = te.stats()["speculative"]
    assert sp["enabled"] and sp["spec_steps"] > 0 and sp["draft_tokens"] > 0
    assert sp["tokens_per_decode_step"] >= 1.0
    assert np.isfinite(te.stats()["photonic"]["modeled_spec_speedup"])


def _oracle(gold, plen):
    def draft(seq, k, _ngram):
        g = len(seq) - plen                  # tokens generated so far
        return np.asarray(gold[g:g + k], np.int32)
    return draft


def test_spec_full_acceptance_with_an_oracle_drafter(models, monkeypatch):
    """A drafter that proposes the true greedy continuation is accepted
    whole: each verify step commits k + 1 tokens."""
    import repro.serving.engine as JE
    import repro_torch.serving.engine as TE
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 128, 7)
    _, plain = F.engines(ARCH, *models, **ENGINE)
    rid = plain.submit(prompt, 8)
    gold = plain.run()[rid][len(prompt):]
    for mod in (JE, TE):
        monkeypatch.setattr(mod, "prompt_lookup_draft",
                            _oracle(gold, len(prompt)))
    te, tout = spec_vs_plain(ARCH, models, [prompt], 8, **ENGINE)
    sp = te.stats()["speculative"]
    assert sp["draft_tokens"] > 0
    assert sp["accepted_tokens"] == sp["draft_tokens"]
    assert sp["acceptance_rate"] == 1.0
    assert sp["tokens_per_decode_step"] > 2.0
    assert sp["repairs"] == 0
    assert te.stats()["photonic"]["modeled_spec_speedup"] > 1.0


def test_spec_stop_mid_draft_clamps_acceptance(models, monkeypatch):
    """A stop token landing mid-draft ends the request there, and only
    the committed draft tokens count as accepted."""
    import repro.serving.engine as JE
    import repro_torch.serving.engine as TE
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 128, 7)
    _, plain = F.engines(ARCH, *models, **ENGINE)
    rid = plain.submit(prompt, 8)
    gold = plain.run()[rid][len(prompt):]
    stop_at = next(i for i in range(1, len(gold))
                   if gold[i] not in gold[:i])
    for mod in (JE, TE):
        monkeypatch.setattr(mod, "prompt_lookup_draft",
                            _oracle(gold, len(prompt)))
    stop = SamplingParams(stop=(int(gold[stop_at]),))
    je, te = F.engines(ARCH, *models, spec_k=3, **ENGINE)
    rids = [e.submit(prompt, 8, sampling=stop) for e in (je, te)]
    jout, tout = ([e.run()[r]] for e, r in zip((je, te), rids))
    F.check_same_engine(je, jout, te, tout)
    np.testing.assert_array_equal(tout[0][len(prompt):], gold[:stop_at + 1])
    sp = te.stats()["speculative"]
    steps = [e for e in te.scheduler.trace if e["event"] == "spec_decode"]
    assert sp["accepted_tokens"] == \
        sum(e["committed"] for e in steps) - (len(steps) - 1)
    assert sp["accepted_tokens"] < sp["draft_tokens"]
    assert sp["acceptance_rate"] == pytest.approx(
        sp["accepted_tokens"] / sp["draft_tokens"])


def test_spec_respects_max_new_budget(models):
    rng = np.random.default_rng(9)
    prompt = periodic_prompt(rng, 128)
    te, tout = spec_vs_plain(ARCH, models, [prompt], 7,
                             **{**ENGINE, "max_model_len": 16})
    assert tout[0].shape == (16,)
    assert len(next(iter(te.requests.values())).out) == 7


def test_scheduler_budget_charges_speculative_rows():
    """A decode row of a speculative engine burns up to spec_k + 1
    compute tokens a step, so the prefill chunk shrinks by that much."""
    from repro.serving import BlockKVCache as JCache, Request as JRequest
    from repro.serving import Scheduler as JSched
    from repro.serving import SchedulerConfig as JSchedCfg
    from repro_torch.serving import (BlockKVCache, Request, Scheduler,
                                     SchedulerConfig)
    jcfg, tcfg = F.cfgs(ARCH, "bnn")
    got = []
    for cache, sched_cls, cfg_cls, req_cls in (
            (JCache(jcfg, num_blocks=64, block_size=4, max_model_len=32),
             JSched, JSchedCfg, JRequest),
            (BlockKVCache(tcfg, num_blocks=64, block_size=4,
                          max_model_len=32),
             Scheduler, SchedulerConfig, Request)):
        sched = sched_cls(cfg_cls(max_batch=4, prefill_chunk=16,
                                  max_batched_tokens=12, decode_cost=4),
                          cache)
        sched.submit(req_cls(0, np.zeros(20, np.int32), 4), step=0)
        first = sched.schedule(0).prefill_tokens
        sched.running[0].state = type(sched.running[0].state)("decode")
        sched.submit(req_cls(1, np.zeros(20, np.int32), 4), step=1)
        plan = sched.schedule(1)
        got.append((first, len(plan.decode), plan.prefill_tokens))
    assert got[0] == got[1] == (12, 1, 12 - 4)


def test_engine_wires_decode_cost_from_spec_k(models):
    for kw, cost in ((dict(), 1), (dict(spec_k=3), 4),
                     (dict(spec_k=9), ENGINE["prefill_chunk"])):
        je, te = F.engines(ARCH, *models, **{**ENGINE, **kw})
        assert te.scheduler.cfg.decode_cost == \
            je.scheduler.cfg.decode_cost == cost
        assert te.stats()["speculative"]["spec_k"] == cost - 1
