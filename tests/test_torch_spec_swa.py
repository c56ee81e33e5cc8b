"""Speculative decoding of the port against the JAX package on the
reduced mixtral (sliding-window ring, MoE): greedy speculative tokens equal plain decoding's, also
across a forced preemption; the port's tokens, stats and scheduler
events equal the JAX engine's.  Every comparison is exact."""
import numpy as np
import pytest
import torch

import _torch_family as F
from test_torch_spec import ENGINE, periodic_prompt, spec_vs_plain
from test_torch_spec_families import preempt_after

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


def test_spec_greedy_matches_plain(models):
    rng = np.random.default_rng(6)
    prompts = [periodic_prompt(rng, 128) for _ in range(2)]
    te, _ = spec_vs_plain(ARCH, models, prompts, 8, **ENGINE)
    sp = te.stats()["speculative"]
    assert sp["spec_steps"] > 0 and sp["draft_tokens"] > 0


def test_spec_survives_forced_preempt(models):
    rng = np.random.default_rng(7)
    prompts = [periodic_prompt(rng, 128) for _ in range(2)]
    te, _ = spec_vs_plain(ARCH, models, prompts, 10,
                          drive=preempt_after(prompts, 10, 7),
                          **{**ENGINE, "max_batch": 2, "max_model_len": 40})
    assert te.stats()["preemptions"] >= 1
