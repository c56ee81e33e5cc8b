"""Speculative decoding of the port against the JAX package on the other
mixer families (tests/test_torch_spec.py has paged GQA): here the
reduced mamba2 (recurrent slots); tests/test_torch_spec_mla.py and
tests/test_torch_spec_swa.py have deepseek-v2-lite (MLA latents) and
mixtral (sliding-window ring, MoE).
Greedy speculative tokens equal plain decoding's, also across a forced
preemption; the port's tokens, stats and scheduler events equal the JAX
engine's.

mamba2: JAX's own per-family case finds no draft on its prompts
(ROADMAP.md queue 3), so this one takes a periodic trace on which
drafts are proposed, partly accepted and rolled back: it asserts verify
steps, ``0 < accepted < drafted`` and ``repairs >= 1``, and holds the
port's tokens to JAX's plain engine.  An oracle drafter is accepted
whole there, with no repair.  The jamba hybrid:
tests/test_torch_spec_hybrid.py.  Every comparison is exact."""
import numpy as np
import pytest
import torch

import _torch_family as F
from test_torch_spec import ENGINE, _oracle, spec_vs_plain

torch.set_num_threads(1)

SSM = "mamba2-1.3b"


@pytest.fixture(scope="module")
def models():
    return F.models(SSM)


def ssm_trace():
    """Two periodic prompts on which the reduced mamba2 drafts, accepts
    one draft token and rejects the rest."""
    rng = np.random.default_rng(6)
    return [np.tile(rng.integers(0, 128, 3), 5)[:12] for _ in range(2)]


def preempt_after(prompts, gen, steps):
    """Submit all, step ``steps`` times, preempt the policy's victim, run
    to the end."""
    def drive(eng):
        rids = [eng.submit(p, gen) for p in prompts]
        for _ in range(steps):
            eng.step()
        eng.scheduler._preempt_one(eng.step_count, None)
        out = eng.run()
        return [out[r] for r in rids]
    return drive


def test_spec_ssm_verifies_accepts_part_and_repairs(models):
    te, _ = spec_vs_plain(SSM, models, ssm_trace(), 16,
                          jax_plain=True, **{**ENGINE, "max_model_len": 40})
    sp = te.stats()["speculative"]
    assert sp["spec_steps"] > 0 and sp["draft_tokens"] > 0
    assert 0 < sp["accepted_tokens"] < sp["draft_tokens"]
    assert sp["repairs"] >= 1


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_spec_ssm_survives_forced_preempt(models, policy):
    te, _ = spec_vs_plain(SSM, models, ssm_trace(), 10,
                          drive=preempt_after(ssm_trace(), 10, 7),
                          preempt_policy=policy,
                          **{**ENGINE, "max_batch": 2, "max_model_len": 40})
    assert te.stats()["preemptions"] >= 1


def test_spec_ssm_full_acceptance_needs_no_repair(models, monkeypatch):
    import repro.serving.engine as JE
    import repro_torch.serving.engine as TE
    prompt = np.random.default_rng(11).integers(0, 128, 7)
    _, plain = F.engines(SSM, *models, **ENGINE)
    rid = plain.submit(prompt, 8)
    gold = plain.run()[rid][len(prompt):]
    for mod in (JE, TE):
        monkeypatch.setattr(mod, "prompt_lookup_draft",
                            _oracle(gold, len(prompt)))
    te, _ = spec_vs_plain(SSM, models, [prompt], 8, **ENGINE)
    sp = te.stats()["speculative"]
    assert sp["accepted_tokens"] == sp["draft_tokens"] > 0
    assert sp["tokens_per_decode_step"] > 2.0 and sp["repairs"] == 0
