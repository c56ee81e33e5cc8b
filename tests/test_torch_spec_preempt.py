"""Speculative decoding of the port against the JAX package, continued
(tests/test_torch_spec.py): on the reduced bnn-lm-100m, greedy
speculative tokens equal plain decoding's across a forced preemption
(swap and recompute) and over a sliding-window ring that wraps while
drafts are partly rejected.  In each, the port's tokens, stats and
scheduler events equal the JAX engine's.  Every comparison is exact."""
import numpy as np
import pytest
import torch

from test_torch_spec import ARCH, ENGINE, periodic_prompt, spec_vs_plain
import _torch_family as F

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_spec_survives_forced_preempt(models, policy):
    rng = np.random.default_rng(7)
    prompts = [periodic_prompt(rng, 128) for _ in range(2)]

    def drive(eng):
        rids = [eng.submit(p, 8) for p in prompts]
        for _ in range(5):
            eng.step()
        eng.scheduler._preempt_one(eng.step_count, None)
        out = eng.run()
        return [out[r] for r in rids]
    te, _ = spec_vs_plain(ARCH, models, prompts, 8, drive=drive,
                          **{**ENGINE, "max_batch": 2},
                          preempt_policy=policy)
    assert te.stats()["preemptions"] >= 1


def test_spec_rollback_on_ring_tables(models):
    """A partly accepted draft over a sliding-window ring: rejected
    writes wrapped into the ring stay invisible once lengths rewind,
    through several wraps."""
    rng = np.random.default_rng(8)
    prompts = [periodic_prompt(rng, 128) for _ in range(2)]
    te, _ = spec_vs_plain(
        ARCH, models, prompts, 14, change=lambda c: c.replace(
            sliding_window=5),
        block_size=2, num_blocks=65, max_batch=2, max_model_len=32)
    blk = te.stats()["mixer"]["blocks"]
    assert blk["layout"] == "ring" and blk["ring_reuses"] > 0
    sp = te.stats()["speculative"]
    assert 0 < sp["accepted_tokens"] < sp["draft_tokens"]
