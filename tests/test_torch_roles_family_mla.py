"""Roles 1:1 (a prefill and a decode shard) on the reduced
deepseek-v2-lite-16b: paged MLA latents cross the swap-to-peer plane.
One JAX ``ShardedEngine`` serves the family's prompts greedy, then
sampled, and the port's does the same: tokens, handoffs,
``handoff_bytes``, every shard's scheduler events, the slots moved and
the stats' counts equal (tests/_torch_shards.py); the port's tokens also
equal its single ``Engine``'s."""
import pytest

import _torch_shards as H

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def runs(family_models):
    jcfg, jparams = family_models["mla"]
    return H.family_runs(ARCH, jcfg, jparams)


@pytest.mark.parametrize("run", [0, 1], ids=["greedy", "sampled"])
def test_one_to_one_equals_jax_sharded_engine(runs, run):
    got = H.check_family_story(runs, run)


def test_one_to_one_tokens_equal_one_engine(runs):
    out, (tcfg, tp), ps = runs
    H.assert_same_tokens(out["torch"][0]["tokens"], H.port_tokens(
        tcfg, tp, ps, H.FAMILY["max_news"]))
