"""The port's streaming front-end (``serving/frontend.py``) and the
engine's commit callback and cancellation, the cases of
tests/test_frontend.py, on the reduced bnn-lm-100m with the JAX weights
(``interop.params_from_numpy``).

Streams: the concatenated commits equal ``run()``'s tokens under
recompute preemption (a regenerated prefix is not delivered twice) and
with speculative bursts (an oracle drafter), and equal the JAX engine's
tokens.  Cancellation: a storm over queued, running and swapped
requests frees every block, counts no swap_lost and ends every stream;
a queued request cancelled before any step streams nothing; cancelling
from a commit callback leaves the other rows' decode untouched.  The
asyncio front-end with two tenants under slo, a mid-decode cancel and a
scoring request gives the JAX front-end's streams, cancel point and
logprobs (LOGPROB_TOL), and ``generate`` equals ``run()``."""
import asyncio

import numpy as np
import pytest
import torch

import _torch_family as F
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serving import Frontend as JFrontend
from repro_torch.serving import Engine, EngineConfig, Frontend, State
from repro_torch.serving import engine as E

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"
LOGPROB_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH), F.cfgs(ARCH, "bnn")


def _kw(**kw):
    return {**dict(block_size=4, num_blocks=40, max_batch=3, prefill_chunk=4,
                   max_model_len=24, prefix_cache=False), **kw}


def _engine(models, **kw):
    (_jp, tp), (_jc, tcfg) = models
    return Engine(tp, tcfg, EngineConfig(**_kw(**kw)), device="cpu")


def _jengine(models, **kw):
    (jp, _tp), (jcfg, _tc) = models
    return JEngine(jp, jcfg, JEngineConfig(**_kw(**kw), attn_impl="xla",
                                           bnn_impl="xla"))


def _prompts(vocab, n, plen, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (n, plen)).astype(np.int32)


def _collect_streams(eng):
    """Record every burst per rid; no commit after a request's last."""
    got: dict[int, list[list[int]]] = {}
    done: dict[int, bool] = {}

    def cb(rid, tokens, is_done):
        got.setdefault(rid, []).append(tokens)
        assert not done.get(rid), f"commit after done for rid {rid}"
        if is_done:
            done[rid] = True
    eng.set_commit_callback(cb)
    return got, done


def test_stream_equals_run_under_recompute_and_jax(models):
    vocab = models[1][1].vocab
    prompts = _prompts(vocab, 3, 8)
    kw = dict(num_blocks=11, preempt_policy="recompute")
    eng = _engine(models, **kw)
    got, done = _collect_streams(eng)
    rids = [eng.submit(p, 8) for p in prompts]
    out = eng.run()
    assert eng.scheduler.preempts > 0      # the pool thrashed
    je = _jengine(models, **kw)
    jrids = [je.submit(p, 8) for p in prompts]
    jout = je.run()
    for rid, jrid in zip(rids, jrids):
        assert done[rid]
        streamed = [t for burst in got[rid] for t in burst]
        np.testing.assert_array_equal(streamed, out[rid][8:])
        np.testing.assert_array_equal(out[rid], jout[jrid])


def test_stream_speculative_bursts(models, monkeypatch):
    """Whole accepted bursts (an oracle drafter that is always right):
    the concatenation still equals the output."""
    prompts = _prompts(models[1][1].vocab, 2, 8)
    plain = _engine(models, max_model_len=40)
    prids = [plain.submit(p, 16) for p in prompts]
    pout = plain.run()
    gold = [pout[r][8:] for r in prids]

    def oracle(seq, k, ngram):
        for p, g in zip(prompts, gold):
            if np.array_equal(seq[:8], p):
                n = len(seq) - 8
                return np.asarray(g[n:n + k], np.int32)
        return np.asarray([], np.int32)

    monkeypatch.setattr(E, "prompt_lookup_draft", oracle)
    eng = _engine(models, spec_k=3, max_model_len=40)
    got, done = _collect_streams(eng)
    rids = [eng.submit(p, 16) for p in prompts]
    out = eng.run()
    assert eng.stats()["speculative"]["accepted_tokens"] > 0
    assert any(len(b) > 1 for rid in rids for b in got[rid])
    for rid, g in zip(rids, gold):
        assert done[rid]
        np.testing.assert_array_equal([t for b in got[rid] for t in b], g)
        np.testing.assert_array_equal(out[rid][8:], g)


def test_cancel_storm_releases_everything(models):
    eng = _engine(models, num_blocks=11, max_batch=3, preempt_policy="swap")
    got, done = _collect_streams(eng)
    rids = [eng.submit(p, 8) for p in _prompts(models[1][1].vocab, 6, 8)]
    for _ in range(9):       # some running, some queued, some swapped
        eng.step()
    states = {eng.requests[r].state for r in rids}
    assert {State.SWAPPED, State.QUEUED, State.DECODE} <= states
    for rid in rids:
        if eng.requests[rid].state is not State.FINISHED:
            assert eng.cancel(rid)
            assert not eng.cancel(rid)          # already terminal
    assert eng.scheduler.idle
    alloc = eng.cache.attn.allocator
    assert alloc.num_used == 0 and alloc.num_free == alloc.capacity
    alloc.check()
    assert eng.scheduler.swap_losts == 0
    assert eng.stats()["cancelled"] == sum(
        eng.requests[r].state is State.CANCELLED for r in rids) > 0
    for rid in rids:
        assert done[rid]                        # every stream ended
        if eng.requests[rid].state is State.CANCELLED:
            ev = [e for e in eng.scheduler.trace
                  if e["rid"] == rid and e["event"] == "cancelled"]
            assert len(ev) == 1
            assert ev[0]["generated"] == len(eng.requests[rid].out)
            assert eng.requests[rid].host_kv is None
    assert not any(e["event"] == "swap_lost" for e in eng.scheduler.trace)
    assert eng.cancel(999) is False             # unknown rid


def test_cancel_queued_before_any_step(models):
    eng = _engine(models, max_batch=1)
    got, done = _collect_streams(eng)
    keep, drop = (eng.submit(p, 4)
                  for p in _prompts(models[1][1].vocab, 2, 8))
    assert eng.cancel(drop)
    out = eng.run()
    assert drop not in out and keep in out
    assert done[drop] and got[drop] == [[]]     # terminal commit, no tokens


def test_cancel_from_commit_callback(models):
    eng = _engine(models)
    target = {}

    def cb(rid, tokens, is_done):
        if rid == target.get("rid") and len(eng.requests[rid].out) >= 3:
            eng.cancel(rid)
    eng.set_commit_callback(cb)
    prompts = _prompts(models[1][1].vocab, 3, 8)
    rids = [eng.submit(p, 8) for p in prompts]
    target["rid"] = rids[1]
    out = eng.run()
    victim = eng.requests[rids[1]]
    assert victim.state is State.CANCELLED and 3 <= len(victim.out) < 8
    assert rids[1] not in out
    ref = _engine(models)
    rrids = [ref.submit(p, 8) for p in prompts]
    rout = ref.run()
    for rid, rrid in ((rids[0], rrids[0]), (rids[2], rrids[2])):
        np.testing.assert_array_equal(out[rid], rout[rrid])
    np.testing.assert_array_equal(victim.full_sequence(),
                                  rout[rrids[1]][:8 + len(victim.out)])
    assert eng.cache.attn.allocator.num_used == 0
    eng.cache.attn.allocator.check()


def _two_tenants(fe_cls, eng, prompts):
    """Two tenants' streams, a mid-decode cancel and a scoring request on
    one event loop."""
    async def go():
        async with fe_cls(eng) as fe:
            web = fe.submit(prompts[0], 8, tenant="web")
            bulk = fe.submit(prompts[1], 8, tenant="bulk")
            victim = fe.submit(prompts[2], 8, tenant="bulk")

            async def consume(rid, cancel_at=None):
                toks = []
                async for burst in fe.stream(rid):
                    toks.extend(burst)
                    if cancel_at and len(toks) >= cancel_at:
                        fe.cancel(rid)
                return toks

            streams = await asyncio.gather(
                consume(web), consume(bulk), consume(victim, 2),
                fe.score(prompts[3], tenant="bulk"))
            return (web, bulk, victim), streams
    return asyncio.run(go())


def test_frontend_two_tenants_cancel_and_score_equal_jax(models):
    kw = dict(max_batch=2, policy="slo",
              tenants="web=latency:0,bulk=throughput:0")
    prompts = _prompts(models[1][1].vocab, 4, 8)
    eng, je = _engine(models, **kw), _jengine(models, **kw)
    (web, bulk, victim), (wt, bt, vt, score) = _two_tenants(Frontend, eng,
                                                           prompts)
    _jrids, (jwt, jbt, jvt, jscore) = _two_tenants(JFrontend, je, prompts)
    assert (wt, bt, vt) == (jwt, jbt, jvt)
    assert eng.requests[web].slo_class == "latency"
    assert eng.requests[bulk].slo_class == "throughput"
    assert eng.requests[victim].state is State.CANCELLED
    assert 2 <= len(vt) < 8
    ref = _engine(models, max_batch=2)
    r0, r1 = ref.submit(prompts[0], 8), ref.submit(prompts[1], 8)
    out = ref.run()
    np.testing.assert_array_equal(wt, out[r0][8:])
    np.testing.assert_array_equal(bt, out[r1][8:])
    assert score["rid"] == jscore["rid"] and score["scored_tokens"] == 7
    np.testing.assert_allclose(score["logprobs"], jscore["logprobs"],
                               **LOGPROB_TOL)
    assert eng.cache.attn.allocator.num_used == 0
    st = eng.stats()
    assert st["tenants"] == je.stats()["tenants"] == {}   # all drained
    assert st["cancelled"] == 1 and st["scoring"]["requests"] == 1


def test_frontend_generate_matches_engine_run(models):
    prompt = _prompts(models[1][1].vocab, 1, 8)[0]
    ref = _engine(models)
    rid = ref.submit(prompt, 8)
    want = ref.run()[rid]

    async def go():
        async with Frontend(_engine(models)) as fe:
            return await fe.generate(prompt, 8)

    np.testing.assert_array_equal(asyncio.run(go()), want)


def test_frontend_surfaces_a_failed_step(models):
    """The drive loop catches nothing: a step that raises ends the
    driver, and leaving the front-end raises it."""
    eng = _engine(models)

    def broken():
        raise RuntimeError("step failed")
    eng.step = broken

    async def go():
        async with Frontend(eng) as fe:
            fe.submit(_prompts(models[1][1].vocab, 1, 8)[0], 4)
            await asyncio.sleep(0)
            await asyncio.sleep(0)

    with pytest.raises(RuntimeError, match="step failed"):
        asyncio.run(go())
