"""Roles 1:1 on the reduced jamba hybrid: each handoff moves both
members, the SSD slot and the paged K/V blocks.  One JAX
``ShardedEngine`` serves the family's prompts greedy, then sampled, and
the port's does the same: tokens, handoffs, ``handoff_bytes``, every
shard's scheduler events, the slots moved and the stats' counts equal
(tests/_torch_shards.py); the port's tokens also equal its single
``Engine``'s."""
import pytest

import _torch_shards as H

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def runs(jamba_models):
    jcfg, jparams = jamba_models
    return H.family_runs(ARCH, jcfg, jparams)


@pytest.mark.parametrize("run", [0, 1], ids=["greedy", "sampled"])
def test_one_to_one_equals_jax_sharded_engine(runs, run):
    got = H.check_family_story(runs, run)
    # both members cross: a slot host copy and blocks for each request
    assert got["slots_moved"][0] == len(runs[2])
    assert got["stats"]["handoff"]["handoff_bytes"] > 0


def test_one_to_one_tokens_equal_one_engine(runs):
    out, (tcfg, tp), ps = runs
    H.assert_same_tokens(out["torch"][0]["tokens"], H.port_tokens(
        tcfg, tp, ps, H.FAMILY["max_news"]))
