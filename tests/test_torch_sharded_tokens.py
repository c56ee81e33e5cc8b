"""The port's ``ShardedEngine`` gives one JAX ``Engine``'s tokens: the
story of tests/test_torch_sharded.py (a migration mid-decode and a
migration onto a shard holding the whole hash chain: re-adopted from an
empty host buffer), 2 and 4 shards greedy and sampled, a migration with
a speculative draft in flight (the destination drafts on); the kill
story of tests/test_torch_sharded_fault.py, a killed prefill shard under
1:2 (its prompts requeue on the decode shards), a shard reaped by the
heartbeat monitor at an explicit clock; the refusals of ``migrate``.
The JAX reference is built once (``JaxReference``)."""
import pytest

import _torch_shards as H
from repro_torch.serving import State, roles as TR
from test_torch_sharded import ARCH, SHARED_SEED, STORY, story
from test_torch_sharded_fault import KILL, kill_story

SPEC = dict(lens=[8, 4, 8], max_news=[12, 8, 8], seed=23)
PREFILL_KILL = dict(lens=[8, 8, 8, 8], max_news=[8, 8, 8, 8], seed=37)


@pytest.fixture(scope="module")
def runs(bnn_cfg, bnn_params):
    """The port's model, the story's prompts and the JAX reference."""
    tcfg, tp = H.port_model(ARCH, bnn_params)
    ps = H.prompts(bnn_cfg.vocab, STORY["lens"], STORY["seed"])
    return (tcfg, tp), H.JaxReference(bnn_cfg, bnn_params), ps


def test_story_tokens_equal_one_jax_engine(runs, bnn_cfg):
    (tcfg, tp), ref, ps = runs
    shared = H.prompts(bnn_cfg.vocab, [8], seed=SHARED_SEED)[0]
    rec = story(H.port_sharded(tcfg, tp, 2), TR.host_bytes, ps, shared)
    H.assert_same_tokens(rec["tokens"], ref.tokens(ps, STORY["max_news"]))
    want = ref.tokens([shared], [8])[0]
    H.assert_same_tokens(rec["shared_tokens"], [want, want])


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_tokens_equal_one_jax_engine(runs, n_shards, sampled):
    (tcfg, tp), ref, ps = runs
    se = H.port_sharded(tcfg, tp, n_shards)
    samp = H.sampling("torch") if sampled else (lambda i: None)
    rids = [se.submit(p, m, sampling=samp(i))
            for i, (p, m) in enumerate(zip(ps, STORY["max_news"]))]
    got = se.run()
    H.assert_same_tokens([got[r] for r in rids], ref.tokens(
        ps, STORY["max_news"], sampling=H.sampling("jax") if sampled
        else None))
    st = se.stats()
    assert st["finished"] == len(rids) and st["n_shards"] == n_shards
    assert st["decoded_tokens"] == sum(p["decoded_tokens"]
                                       for p in st["per_shard"])
    assert sum(1 for p in st["per_shard"] if p["decoded_tokens"]) >= 2
    with pytest.raises(ValueError, match="not alive"):
        se.submit(ps[0], 4, shard=7)


def test_migrate_with_a_speculative_draft_in_flight(runs, bnn_cfg):
    """The victim's last verify step wrote a draft past its committed
    position and rolled the rest back; the export serializes the
    position-consistent state and the destination drafts on."""
    (tcfg, tp), ref, _ps = runs
    ps = H.prompts(bnn_cfg.vocab, SPEC["lens"], SPEC["seed"])
    se = H.port_sharded(tcfg, tp, 2, spec_k=3)
    rids = [se.submit(p, m) for p, m in zip(ps, SPEC["max_news"])]
    victim, req = rids[0], se.requests[rids[0]]
    while not (req.state == State.DECODE and len(req.out) > 1
               and se.engines[se.shard_of[victim]]._draft_tokens > 0):
        assert not req.done
        se.step()
    src = se.shard_of[victim]
    dst = se.migrate(victim)
    assert dst != src
    got = se.run()
    H.assert_same_tokens([got[r] for r in rids],
                         ref.tokens(ps, SPEC["max_news"]))
    assert se.engines[dst]._spec_rows > 0


def test_migrate_refuses_what_jax_refuses(runs, bnn_cfg):
    (tcfg, tp), _ref, ps = runs
    se = H.port_sharded(tcfg, tp, 2)
    rid = se.submit(ps[0], 2)
    assert se.migrate(rid, se.shard_of[rid]) == se.shard_of[rid]   # no-op
    se.kill_shard(1)
    with pytest.raises(ValueError, match="not alive"):
        se.migrate(rid, 1)
    se.run()
    with pytest.raises(ValueError, match="already finished"):
        se.migrate(rid)


def test_kill_story_tokens_equal_one_jax_engine(runs, bnn_cfg):
    (tcfg, tp), ref, _ps = runs
    ps = H.prompts(bnn_cfg.vocab, KILL["lens"], KILL["seed"])
    rec = kill_story(H.port_sharded(tcfg, tp, 2), ps)
    H.assert_same_tokens(rec["tokens"], ref.tokens(ps, KILL["max_news"]))


def test_killed_prefill_shard_requeues_on_survivors(runs, bnn_cfg):
    """1:2 with the prefill shard killed mid-prefill: its prompts requeue
    on the decode shards (recompute from scratch), tokens unchanged, and
    fresh submissions fall back to the decode shards."""
    (tcfg, tp), ref, _ps = runs
    ps = H.prompts(bnn_cfg.vocab, PREFILL_KILL["lens"], PREFILL_KILL["seed"])
    se = H.port_sharded(tcfg, tp, 3, roles="1:2")
    rids = [se.submit(p, m) for p, m in zip(ps, PREFILL_KILL["max_news"])]
    se.step()
    doomed = [r for r in rids if se.shard_of[r] == 0]
    assert doomed
    se.kill_shard(0)
    assert se.alive == [1, 2]
    assert all(se.shard_of[r] in (1, 2) for r in rids)
    late = se.submit(ps[0], 4)
    assert se.shard_of[late] in (1, 2)
    out = se.run()
    H.assert_same_tokens([out[r] for r in rids],
                         ref.tokens(ps, PREFILL_KILL["max_news"]))
    assert len(out[late]) == len(ps[0]) + 4
    st = se.stats()
    assert st["requeued_lost"] >= len(doomed)
    assert sum(p["prefill_tokens"] for p in st["per_shard"][1:]) > 0


def test_reap_kills_a_silent_shard_at_an_explicit_clock(runs, bnn_cfg):
    (tcfg, tp), ref, _ps = runs
    from repro_torch.serving import EngineConfig, ShardedEngine
    se = ShardedEngine(tp, tcfg, EngineConfig(**H.EKW), 2, dead_after=5.0,
                       devices=H.CPU)
    ps = H.prompts(bnn_cfg.vocab, [4, 4], seed=13)
    rids = [se.submit(p, 6, shard=i) for i, p in enumerate(ps)]
    se.step()                                     # both shards beat
    now = se.monitor._last_beat[1]
    assert se.reap(now) == []                     # both alive
    se.monitor.beat(1, now - 10.0)                # shard 1 goes silent
    assert se.reap(now) == [1]
    assert se.alive == [0] and se.shard_of[rids[1]] == 0
    out = se.run()
    H.assert_same_tokens([out[r] for r in rids], ref.tokens(ps, [6, 6]))
