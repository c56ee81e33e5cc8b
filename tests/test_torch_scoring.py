"""Teacher-forced scoring through the port's front-end against the JAX
package's, on the reduced bnn-lm-100m (the reduced jamba hybrid, whose
composite cache takes the scoring branch in both members, runs these
tests in tests/test_torch_scoring_hybrid.py).

Both packages' engines, under the JAX defaults (prefix cache, swap),
serve the same traffic through their ``Frontend``: generation requests
that register a shared prompt head, then scoring requests over that
head (tenant ``batch``, throughput class by default) beside a repeat of
the first, then a request that shares a scoring prompt's head.  The
scoring requests adopt no prefix (their logits are needed at every
position) and register their own blocks for the request after them;
their logprobs agree with JAX's within LOGPROB_TOL (float32 logits
summed in float64 on both sides); the
generated tokens, the scheduler's events, ``stats()["scoring"]``, the
prefix-cache counts and the photonic section (its scoring report
included) equal JAX's."""
import asyncio
import math

import numpy as np
import pytest
import torch

import _torch_family as F
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serving import Frontend as JFrontend
from repro_torch.serving import Engine, EngineConfig, Frontend

torch.set_num_threads(1)

LOGPROB_TOL = dict(rtol=1e-4, atol=1e-4)
GEN = 6
CASES = {
    "bnn-lm-100m": dict(block_size=4, num_blocks=24, max_batch=3,
                        prefill_chunk=4, max_model_len=40),
    "jamba-1.5-large-398b": dict(block_size=4, num_blocks=24, max_batch=3,
                                 prefill_chunk=4, max_model_len=40,
                                 num_slots=5),
}


def _traffic(vocab):
    rng = np.random.default_rng(11)
    head = rng.integers(0, vocab, 12)
    gens = [np.concatenate([head, rng.integers(0, vocab, n)])
            for n in (3, 6)]
    scores = [np.concatenate([head, rng.integers(0, vocab, n)])
              for n in (5, 9)] + [rng.integers(0, vocab, 7)]
    late = [np.concatenate([scores[1][:16], rng.integers(0, vocab, 2)])]
    return gens, scores, late


def _serve(fe_cls, eng, gens, scores, late):
    """(generated sequences: gens, the repeat, late; scoring results)"""
    async def go():
        async with fe_cls(eng) as fe:
            first = await asyncio.gather(*(fe.generate(p, GEN)
                                           for p in gens))
            mid = await asyncio.gather(
                *(fe.score(p, tenant="batch") for p in scores),
                fe.generate(gens[0], GEN))
            last = await asyncio.gather(*(fe.generate(p, GEN)
                                          for p in late))
        return first + mid[len(scores):] + last, mid[:len(scores)]
    return asyncio.run(go())


def serve_both(arch):
    jp, tp = F.models(arch)
    jcfg, tcfg = F.cfgs(arch, "bnn")
    kw = dict(CASES[arch], policy="slo", tenants="batch=throughput")
    traffic = _traffic(jcfg.vocab)
    je = JEngine(jp, jcfg, JEngineConfig(**kw, attn_impl="xla",
                                         bnn_impl="xla"))
    te = Engine(tp, tcfg, EngineConfig(**kw), device="cpu")
    return arch, {"jax": (je, _serve(JFrontend, je, *traffic)),
                  "torch": (te, _serve(Frontend, te, *traffic))}, traffic


@pytest.fixture(scope="module")
def scored():
    return serve_both("bnn-lm-100m")


def test_scoring_logprobs_match_jax(scored):
    _arch, runs, (_g, scores, _l) = scored
    (_je, (_jg, jsc)), (te, (_tg, tsc)) = runs["jax"], runs["torch"]
    assert len(tsc) == len(jsc) == len(scores)
    for got, want, p in zip(tsc, jsc, scores):
        assert got["rid"] == want["rid"]
        assert got["scored_tokens"] == want["scored_tokens"] == len(p) - 1
        np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                                   **LOGPROB_TOL)
        assert math.isclose(got["ppl"], want["ppl"], rel_tol=1e-3)
        req = te.requests[got["rid"]]
        assert req.state.value == "finished" and req.out == []
        assert req.skipped_prefill == 0 and req.slo_class == "throughput"


def test_scoring_engine_equals_jax(scored):
    arch, runs, (gens, scores, late) = scored
    (je, (jg, _jsc)), (te, (tg, _tsc)) = runs["jax"], runs["torch"]
    for a, b in zip(jg, tg, strict=True):
        np.testing.assert_array_equal(b, a)
    js_, ts_ = je.stats(), te.stats()
    assert ts_["scoring"] == js_["scoring"] == {
        "requests": len(scores),
        "scored_tokens": sum(len(p) - 1 for p in scores),
        "score_passes": sum(-(-len(p) // 4) for p in scores)}
    assert F.counts(ts_["prefix_cache"]) == F.counts(js_["prefix_cache"])
    got, want = ts_["photonic"], js_["photonic"]
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, float):
            assert math.isclose(got[key], w, rel_tol=F.ENGINE_RTOL), key
        else:
            assert got[key] == w, key
    assert got["modeled_scoring_tokens_per_s"] > 0
    assert [{k: v for k, v in e.items() if k != "slot"}
            for e in te.scheduler.trace] == je.scheduler.trace
    # no scoring request adopted a prefix; the repeat did, and the last
    # request adopted the blocks the second scoring request registered
    admits = {e["rid"]: e for e in te.scheduler.trace
              if e["event"] == "admit"}
    n_gen = len(gens)
    for rid in range(n_gen, n_gen + len(scores)):
        assert admits[rid]["cached_tokens"] == 0
    assert admits[n_gen + len(scores)]["cached_tokens"] > 0
    assert admits[n_gen + len(scores) + 1]["cached_tokens"] == 16
    if arch.startswith("jamba"):
        assert te.cache.ssm is not None and te.cache.attn is not None


def test_scoring_needs_two_tokens_and_ignores_max_new():
    _jp, tp = F.models("bnn-lm-100m")
    tcfg = F.cfgs("bnn-lm-100m", "bnn")[1]
    eng = Engine(tp, tcfg, EngineConfig(**CASES["bnn-lm-100m"]),
                 device="cpu")
    with pytest.raises(ValueError, match=">= 2 prompt tokens"):
        eng.submit([5], 4, score=True)
    rid = eng.submit(np.arange(10), 99, score=True)   # max_new -> 0
    assert eng.requests[rid].max_new == 0
    eng.run()
    req = eng.requests[rid]
    assert len(req.logprobs) == 9 and np.isfinite(req.score_ppl())
    assert eng.stats()["decoded_tokens"] == 0
