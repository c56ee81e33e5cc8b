"""Shard faults of the port's ``ShardedEngine`` against the JAX package.

The kill story of tests/test_sharded.py runs on a JAX ``ShardedEngine``
of 2 shards and on the port's, traced into ring buffers: four requests,
four steps, shard 0 killed.  Equal: the doomed requests and their
states, where every request lands, ``stall_reasons()`` (the rescued
read ``swap_lost``), ``requeued_lost``, the survivor's scheduler events
and its trace records apart from timing (``swap_lost`` with reason
``shard_lost``), the stats' counts (the tokens against one JAX
``Engine``, with a killed prefill shard under 1:2 and a shard reaped by
the heartbeat monitor: tests/test_torch_sharded_tokens.py).  The
refusals (the last shard, the last decode-capable shard, a dead shard)
and ``rebalance`` (queued requests only, within a role class; the
advisory P:D line) as in the JAX package's tests."""
import pytest

import _torch_shards as H
import _torch_trace as TT
from repro_torch.serving import State

ARCH = "bnn-lm-100m"
KILL = dict(lens=[4, 8, 4, 8], max_news=[8, 8, 12, 8], seed=11)


def kill_story(se, ps):
    rec = {}
    se.start_trace()                              # ring-buffer traces
    rids = [se.submit(p, m) for p, m in zip(ps, KILL["max_news"])]
    for _ in range(4):
        se.step()
    doomed = [r for r in rids if se.shard_of[r] == 0]
    rec["doomed"] = [(r, se.requests[r].state.value) for r in doomed]
    se.kill_shard(0)
    rec["alive"] = list(se.alive)
    rec["shard_of"] = [se.shard_of[r] for r in rids]
    rec["stalls"] = se.stall_reasons()
    out = se.run()
    rec["tokens"] = [out[r].tolist() for r in rids]
    rec["stats"] = H.shard_stats(se)
    rec["events"] = H.events(se.engines[1])
    rec["trace"] = [TT.strip(r) for r in se.engines[1].tracer.events()
                    if r["type"] == "request"]
    se.stop_trace()
    return rec


@pytest.fixture(scope="module")
def runs(bnn_cfg, bnn_params):
    tcfg, tp = H.port_model(ARCH, bnn_params)
    ps = H.prompts(bnn_cfg.vocab, KILL["lens"], KILL["seed"])
    out = {"jax": kill_story(H.jax_sharded(bnn_cfg, bnn_params, 2), ps),
           "torch": kill_story(H.port_sharded(tcfg, tp, 2), ps)}
    return out, (tcfg, tp), ps


def test_kill_story_equals_jax_sharded_engine(runs):
    out, _m, _ps = runs
    got, want = out["torch"], out["jax"]
    for key in want:
        assert got[key] == want[key], key
    assert got["alive"] == [1] and set(got["shard_of"]) == {1}
    assert any(state != "queued" for _r, state in got["doomed"])
    assert any(got["stalls"][r][1] == "swap_lost" for r, _s in got["doomed"])
    assert got["stats"]["requeued_lost"] >= 1
    assert got["stats"]["per_shard"][1]["swap_losts"] >= 1
    assert any(r["event"] == "swap_lost" and r.get("reason") == "shard_lost"
               for r in got["trace"])


def test_kill_refusals(runs):
    _out, (tcfg, tp), _ps = runs
    se = H.port_sharded(tcfg, tp, 2)
    se.kill_shard(1)
    with pytest.raises(ValueError, match="not alive"):
        se.kill_shard(1)
    with pytest.raises(RuntimeError, match="last shard"):
        se.kill_shard(0)
    pd = H.port_sharded(tcfg, tp, 2, roles="1:1")
    with pytest.raises(RuntimeError, match="last decode-capable"):
        pd.kill_shard(1)                  # would leave a prefill shard only


def test_rebalance_moves_queued_requests_only(runs, bnn_cfg):
    _out, (tcfg, tp), _ps = runs
    se = H.port_sharded(tcfg, tp, 2)
    ps = H.prompts(bnn_cfg.vocab, [4, 4, 4], seed=9)
    rids = [se.submit(p, 8, shard=0) for p in ps]        # pile on shard 0
    assert se.shard_load(1) == 0
    assert se.rebalance() == 1 and se.migrations == 1
    assert se.shard_of[rids[-1]] == 1                    # the youngest
    assert [se.shard_of[r] for r in rids[:2]] == [0, 0]
    assert se.requests[rids[-1]].state == State.QUEUED   # nothing crossed
    assert se.recommended_roles == ""                    # no prefill shard
    assert len(se.run()) == 3


def test_rebalance_prints_the_advisory_roles(runs, bnn_cfg, capsys):
    """1:2 with every prompt queued on the prefill shard: its pressure
    (prompt tokens to compute) exceeds twice the decode shards' (no
    load), so the advice is 2:1, printed once; nothing is re-roled."""
    _out, (tcfg, tp), _ps = runs
    se = H.port_sharded(tcfg, tp, 3, roles="1:2")
    for p in H.prompts(bnn_cfg.vocab, [8, 8, 8], seed=17):
        se.submit(p, 4)
    assert se.recommend_roles() == "2:1"
    assert se.rebalance() == 0                           # one prefill shard
    se.rebalance()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[sharded] role auto-tune")]
    assert lines == ["[sharded] role auto-tune: observed pressure suggests "
                     "roles 2:1 (currently 1:2); re-launch with --roles 2:1 "
                     "to apply"]
    assert se.stats()["recommended_roles"] == "2:1"
    assert se.roles == ["prefill", "decode", "decode"]
    assert len(se.run()) == 3
