"""The jamba hybrid's joint prefix match against the JAX package (the
hybrid properties of tests/test_slot_snapshots.py, across the two
packages), on the reduced jamba under the prefix cache.

Every layer must resume prefill from one position, so the composite
cache reconciles the attention chain's depth with the slot snapshot
depth: both members skip the same tokens, and when the snapshot index
reaches less deep than the attention chain, the attention member
adopts blocks only down to the snapshot depth.  In each, the port's
tokens, prefix-cache / swap counts, mixer section and scheduler events
equal the JAX engine's, and its tokens equal the same requests served
without the prefix cache.  A Poisson trace under the defaults:
tests/test_torch_hybrid_trace.py.

The JAX side runs its XLA paths, the port its plain kernel versions on
the CPU; every comparison here is exact."""
import numpy as np
import pytest
import torch

import _torch_family as F
from repro_torch.serving import Engine, EngineConfig
from test_torch_slot_snapshots import (ENGINE, _keys, run_one_by_one,
                                       shared_prompts)

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


def _off(models, prompts, gen):
    tcfg = F.cfgs(ARCH, "bnn")[1]
    eng = Engine(models[1], tcfg, EngineConfig(**ENGINE, prefix_cache=False),
                 device="cpu")
    return run_one_by_one(eng, prompts, gen)[0]


def test_joint_match_skips_equal_tokens_in_both_members(models):
    prompts = shared_prompts(128, seed=1)
    je, te = F.engines(ARCH, *models, **ENGINE)
    (jout, jch), (tout, tch) = (run_one_by_one(e, prompts) for e in (je, te))
    F.check_same_engine(je, jout, te, tout)
    assert tch == jch and tch[1] == 1
    st = te.stats()["prefix_cache"]
    assert st["snapshot_hits"] == 2 and st["hits"] >= 4   # blocks + snaps
    assert st["skipped_prefill_tokens"] == 8
    assert te.cache.attn.skipped_prefill_tokens \
        == te.cache.ssm.skipped_prefill_tokens == 8
    for a, b in zip(tout, _off(models, prompts, 6)):
        np.testing.assert_array_equal(a, b)


def test_attention_adopts_only_to_the_snapshot_depth(models):
    """The snapshot index reaches depth 1 while the attention chain
    covers depth 2: the attention member adopts ONE block."""
    prompts = shared_prompts(128, seed=2, tails=(3, 3))
    k1, k2 = _keys(prompts[0], 4, 2)

    def drive(eng):
        run_one_by_one(eng, prompts[:1], gen=4)
        snaps = eng.cache.ssm.snapshots
        assert k2 in snaps
        snaps._free.append(snaps._map.pop(k2))
        assert k1 in snaps and len(eng.cache.attn.prefix) == 2
        rid = eng.submit(prompts[1], 4)
        out = eng.run()[rid]
        assert eng.requests[rid].skipped_prefill == 4      # depth 1, not 2
        return [out]

    je, te = F.engines(ARCH, *models, **ENGINE)
    jout, tout = drive(je), drive(te)
    F.check_same_engine(je, jout, te, tout)
    np.testing.assert_array_equal(tout[0], _off(models, prompts[1:], 4)[0])
