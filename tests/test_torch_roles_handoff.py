"""Prefill->decode handoff (roles 1:2) of the port against the JAX
package.

One story runs on a JAX ``ShardedEngine`` with roles 1:2 and on the
port's: five prompts, all placed on the prefill shard, each handed to
the least-loaded decode shard after its prompt over swap-to-peer, the
destination parking it for the modelled link (``transfer_pending``,
a few steps at 100 Gb/s here).  Equal: placement, tokens,
``handoffs``, ``handoff_bytes``, the modelled transfer, every shard's
scheduler events (``handoff_ready``, ``migrate_out``/``migrate_in``,
the ``transfer_pending`` defers with their deadlines) and the stats'
counts; the division of labour (the prefill shard decodes only first
tokens, the decode shards prefill nothing).  Port only, against one
JAX ``Engine``'s tokens: the story sampled, a slow link (each request
parked the clamp's 256 steps), speculative decoding on the decode
shards (none on the prefill shard), a request cancelled while parked
for handoff (never exported) and a terminal request dropped by an idle
shard's drain."""
import pytest

import _torch_shards as H
from repro_torch.serving import State

ARCH = "bnn-lm-100m"
STORY = dict(lens=[4, 7, 8, 5, 4], max_news=[8, 6, 8, 4, 8], seed=3)


def handoff_story(se, ps):
    rids = [se.submit(p, m) for p, m in zip(ps, STORY["max_news"])]
    rec = {"placed": [se.shard_of[r] for r in rids]}
    out = se.run()
    rec["tokens"] = [out[r].tolist() for r in rids]
    rec["owners"] = [se.shard_of[r] for r in rids]
    rec["stats"] = H.shard_stats(se)
    rec["events"] = [H.events(e) for e in se.engines]
    rec["transfer"] = [(r.transfer_steps, r.transfer_until_step)
                       for r in (se.requests[x] for x in rids)]
    return rec


@pytest.fixture(scope="module")
def runs(bnn_cfg, bnn_params):
    tcfg, tp = H.port_model(ARCH, bnn_params)
    ps = H.prompts(bnn_cfg.vocab, STORY["lens"], STORY["seed"])
    out = {"jax": handoff_story(H.jax_sharded(bnn_cfg, bnn_params, 3, "1:2"),
                                ps),
           "torch": handoff_story(H.port_sharded(tcfg, tp, 3, "1:2"), ps)}
    return out, (tcfg, tp), H.JaxReference(bnn_cfg, bnn_params), ps


def test_handoff_story_equals_jax_sharded_engine(runs):
    out, _m, _ref, ps = runs
    got, want = out["torch"], out["jax"]
    for key in want:
        assert got[key] == want[key], key
    st = got["stats"]
    assert st["roles"] == ["prefill", "decode", "decode"]
    assert got["placed"] == [0] * len(ps)          # fresh prompts: prefill
    assert set(got["owners"]) <= {1, 2}            # finished on decoders
    assert st["handoff"]["handoffs"] == len(ps)
    assert st["handoff"]["handoff_bytes"] > sum(p.nbytes for p in ps)
    pending = [e for ev in got["events"][1:] for e in ev
               if e.get("reason") == "transfer_pending"]
    assert pending and all("until_step" in e for e in pending)


def test_division_of_labour(runs):
    out, _m, _ref, ps = runs
    pre, *dec = out["torch"]["stats"]["per_shard"]
    assert pre["prefill_tokens"] == sum(map(len, ps))
    assert pre["decoded_tokens"] == len(ps)        # the first tokens only
    assert all(d["prefill_tokens"] == 0 for d in dec)
    ev0 = [e["event"] for e in out["torch"]["events"][0]]
    assert ev0.count("handoff_ready") == ev0.count("migrate_out") == len(ps)
    assert "decode" not in ev0                     # no decode row there


def test_handoff_tokens_equal_one_jax_engine(runs):
    out, _m, ref, ps = runs
    H.assert_same_tokens(out["torch"]["tokens"],
                         ref.tokens(ps, STORY["max_news"]))


def test_sampled_handoff_tokens_equal_one_jax_engine(runs):
    _out, (tcfg, tp), ref, ps = runs
    se = H.port_sharded(tcfg, tp, 3, "1:2")
    samp = H.sampling("torch")
    rids = [se.submit(p, m, sampling=samp(i))
            for i, (p, m) in enumerate(zip(ps, STORY["max_news"]))]
    out = se.run()
    H.assert_same_tokens([out[r] for r in rids], ref.tokens(
        ps, STORY["max_news"], sampling=H.sampling("jax")))
    assert se.handoffs == len(ps)


def test_slow_link_parks_each_request(runs, bnn_cfg):
    """At a link of 1e-6 Gb/s each handoff parks its request the clamp's
    256 destination steps (``transfer_pending`` in ``stall_reasons``),
    then it runs to the same tokens."""
    _out, (tcfg, tp), ref, _ps = runs
    ps = H.prompts(bnn_cfg.vocab, [8, 4], seed=41)
    se = H.port_sharded(tcfg, tp, 2, "1:1", link_gbps=1e-6)
    rids = [se.submit(p, 8) for p in ps]
    for _ in range(600):
        se.step()
        if any(se.stall_reasons().get(r, (None, None))[1]
               == "transfer_pending" for r in rids):
            break
    pending = [r for r in rids if se.requests[r].transfer_until_step]
    assert pending and all(se.requests[r].transfer_steps == 256
                           for r in pending)
    out = se.run()
    H.assert_same_tokens([out[r] for r in rids], ref.tokens(ps, [8, 8]))
    defers = [e for e in se.engines[1].scheduler.trace
              if e.get("reason") == "transfer_pending"]
    assert len(defers) >= 256


def test_speculative_decoding_on_the_decode_shards(runs, bnn_cfg):
    _out, (tcfg, tp), ref, _ps = runs
    ps = H.prompts(bnn_cfg.vocab, [8, 4, 8, 6], seed=31)
    max_news = [12, 8, 8, 8]
    se = H.port_sharded(tcfg, tp, 3, "1:2", spec_k=3)
    assert [e._spec_k for e in se.engines] == [0, 3, 3]
    assert se.engines[0]._spec_fn is None and se.engines[0]._decode_fn is None
    rids = [se.submit(p, m) for p, m in zip(ps, max_news)]
    out = se.run()
    H.assert_same_tokens([out[r] for r in rids], ref.tokens(ps, max_news))
    assert sum(e._draft_tokens for e in se.engines[1:]) > 0
    assert se.engines[0]._draft_tokens == 0


def _park(se, rids):
    """Step only the prefill shard (the sharded drain never runs) until
    ``rids`` are parked for handoff."""
    p = se.engines[0]
    for _ in range(30):
        if all(r in p.handoff_ready for r in rids):
            return p
        p.step()
    raise AssertionError("never parked")


def test_cancel_while_parked_never_exports(runs, bnn_cfg):
    _out, (tcfg, tp), _ref, _ps = runs
    se = H.port_sharded(tcfg, tp, 2, "prefill,decode", prefix_cache=False)
    rid = se.submit(H.prompts(bnn_cfg.vocab, [8], seed=51)[0], 8)
    live = se.submit(H.prompts(bnn_cfg.vocab, [8], seed=52)[0], 8)
    p = _park(se, [rid, live])
    assert p.scheduler.stall_reasons()[rid] == ("decode", "awaiting_handoff")
    assert se.cancel(rid)
    assert rid not in p.handoff_ready
    assert se.requests[rid].state is State.CANCELLED
    out = se.run()
    assert rid not in out and live in out
    assert rid not in se.engines[1].requests       # never reached the peer
    assert se.handoffs == 1
    assert p.cache.attn.allocator.num_used == 0


def test_terminal_parked_request_dropped_by_an_idle_shards_drain(
        runs, bnn_cfg):
    _out, (tcfg, tp), _ref, _ps = runs
    se = H.port_sharded(tcfg, tp, 2, "prefill,decode")
    rid = se.submit(H.prompts(bnn_cfg.vocab, [8], seed=53)[0], 8)
    p = _park(se, [rid])
    req = p.requests[rid]
    p.cache.release(req)
    p.scheduler.running.remove(req)
    req.state = State.CANCELLED                  # terminal, still parked
    assert p.scheduler.idle
    se.step()                                    # the drain runs anyway
    assert rid not in p.handoff_ready
    assert rid not in se.engines[1].requests
    assert se.handoffs == 0
