"""The reduced jamba hybrid under ``EngineConfig`` defaults on the Poisson
trace of tests/test_torch_prefix_swap.py, the port's engine against the
JAX engine (split from tests/test_torch_hybrid_snapshots.py): tokens,
prefix-cache / swap counts and scheduler events equal; blocks and slots
swap together; tokens equal a run without the prefix cache and swap.
Every comparison is exact."""
import numpy as np
import pytest
import torch

import _torch_family as F
from repro_torch.serving import Engine, EngineConfig

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


def test_poisson_trace_under_the_defaults_matches_jax(models):
    """The Poisson trace of tests/test_torch_prefix_swap.py (a shared
    head, a whole repeat, a pool small enough to preempt) under
    ``EngineConfig`` defaults: blocks and slots swap together, and the
    tokens equal a run without the prefix cache and swap."""
    kw, shared, tails, gen = F.PREFIX_FAMILIES["bnn-lm-100m"]
    arrival, prompts = F.poisson_trace(128, shared, tails)
    je, te = F.engines(ARCH, *models, **kw)
    jout, tout = (F.drive_trace(e, arrival, prompts, gen) for e in (je, te))
    F.check_same_engine(je, jout, te, tout)
    st = te.stats()
    assert st["prefix_cache"]["snapshot_hits"] > 0
    assert st["swap"]["swap_outs"] > 0 and st["swap"]["swap_ins"] > 0
    assert st["swap"]["swapped_slots"] + \
        st["swap"]["readopted_snapshots"] > 0
    te.cache.attn.allocator.check()
    te.cache.ssm.allocator.check()
    tcfg = F.cfgs(ARCH, "bnn")[1]
    calm = Engine(models[1], tcfg, EngineConfig(
        **{**kw, "num_blocks": 65}, prefix_cache=False,
        preempt_policy="recompute"), device="cpu")
    for a, b in zip(tout, F.drive_trace(calm, arrival, prompts, gen)):
        np.testing.assert_array_equal(a, b)
