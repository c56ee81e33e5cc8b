"""Speculative decoding of the port's jamba hybrid against the JAX
package: one verify step drives both rollbacks (the slot members
restore their pre-verify copies and re-advance, the block members
rewind), and greedy speculative tokens equal plain decoding's (the
port's plain engine, held to JAX's in tests/test_torch_family_hybrid.py).
The port's tokens, stats and scheduler events equal the JAX speculative
engine's.  Every comparison is exact."""
import numpy as np
import pytest
import torch

import _torch_family as F
from test_torch_spec import ENGINE, periodic_prompt, spec_vs_plain

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


def test_spec_greedy_matches_plain_hybrid(models):
    rng = np.random.default_rng(6)
    prompts = [periodic_prompt(rng, 128) for _ in range(2)]
    te, _ = spec_vs_plain(ARCH, models, prompts, 8, **ENGINE)
    assert te.cache.ssm is not None and te.cache.attn is not None
    sp = te.stats()["speculative"]
    assert sp["draft_tokens"] > 0 and sp["repairs"] >= 1
