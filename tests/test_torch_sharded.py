"""The port's ``ShardedEngine`` (mixed shards) against the JAX package.

One story runs on a JAX ``ShardedEngine`` of 2 shards and on the
port's, step for step (the cases of tests/test_sharded.py): placement
by committed-token load, a request migrated mid-decode by swap-to-peer,
then one prompt served on both shards and migrated onto the shard that
holds its hash chain (re-adopted there: no block copied).
Equal: each request's shard, the migrated request's state, re-adoption
depth, prefix key and ``host_bytes``, the re-adopted blocks, every
shard's scheduler events and the stats' counts.  Tokens against one
JAX ``Engine``: tests/test_torch_sharded_tokens.py."""
import pytest

import _torch_shards as H
from repro.serving import roles as JR
from repro_torch.serving import roles as TR

ARCH = "bnn-lm-100m"
STORY = dict(lens=[4, 7, 8, 5, 4], max_news=[8, 6, 8, 4, 8], seed=3)
SHARED_SEED = 7                 # the shared prompt: 2 full blocks


def story(se, host_bytes, ps, shared):
    """The scenario, on either package's ShardedEngine of 2 shards."""
    rec = {}
    rids = [se.submit(p, m) for p, m in zip(ps, STORY["max_news"])]
    rec["placed"] = [se.shard_of[r] for r in rids]
    rec["loads"] = [se.shard_load(i) for i in range(2)]
    for _ in range(5):
        se.step()
    victim = rids[0]
    src = se.shard_of[victim]
    rec["victim"] = se.requests[victim].state.value
    dst = se.migrate(victim)
    req = se.requests[victim]
    rec["migrated"] = (src, dst, req.state.value, req.pos, req.swap_readopt,
                       req.n_registered, req.prefix_key, host_bytes(req))
    out = se.run()
    rec["tokens"] = [out[r].tolist() for r in rids]
    # the same prompt on both shards; the one on shard 0 migrates onto
    # shard 1, which holds its whole hash chain
    ra = se.submit(shared, 8, shard=0)
    rb = se.submit(shared.copy(), 8, shard=1)
    while not all(se.requests[r].state.value == "decode" for r in (ra, rb)):
        se.step()
    se.migrate(ra, 1)
    req = se.requests[ra]
    rec["peer"] = (req.swap_readopt, req.n_registered, req.prefix_key,
                   host_bytes(req), len(req.host_kv[0]["k"]))
    before = se.engines[1].cache.attn.readopted_blocks
    out = se.run()
    rec["readopted"] = se.engines[1].cache.attn.readopted_blocks - before
    rec["shared_tokens"] = [out[ra].tolist(), out[rb].tolist()]
    rec["events"] = [H.events(e) for e in se.engines]
    rec["stats"] = H.shard_stats(se)
    return rec


@pytest.fixture(scope="module")
def runs(bnn_cfg, bnn_params):
    """{"jax", "torch": the story's record} and the shared prompt."""
    tcfg, tp = H.port_model(ARCH, bnn_params)
    ps = H.prompts(bnn_cfg.vocab, STORY["lens"], STORY["seed"])
    shared = H.prompts(bnn_cfg.vocab, [8], seed=SHARED_SEED)[0]
    return {"jax": story(H.jax_sharded(bnn_cfg, bnn_params, 2),
                         JR.host_bytes, ps, shared),
            "torch": story(H.port_sharded(tcfg, tp, 2), TR.host_bytes,
                           ps, shared)}, shared


def test_story_equals_jax_sharded_engine(runs):
    out, _shared = runs
    got, want = out["torch"], out["jax"]
    for key in want:
        assert got[key] == want[key], key
    assert got["placed"][:2] == [0, 1]          # least loaded, then index
    assert got["victim"] == "decode"
    assert got["migrated"][1] != got["migrated"][0]
    assert got["stats"]["migrations"] == 2


def test_peer_readoption_copies_no_held_block(runs):
    """Migrated right after its first token (pos 8 = 2 full blocks), the
    request's whole cache is the peer's chain: no block is copied, the
    migration moves the tokens alone, and the destination's swap-in
    re-adopts both blocks from an empty host buffer
    (tests/test_torch_sharded_tokens.py holds the tokens)."""
    out, shared = runs
    readopt, n_reg, key, n_bytes, n_copied = out["torch"]["peer"]
    assert readopt == n_reg == 2 and key         # the whole chain held
    assert n_copied == 0                         # no tail to copy
    assert n_bytes == shared.nbytes + 4          # prompt + one token
    assert out["torch"]["readopted"] >= readopt
    events = [e["event"] for e in out["torch"]["events"][1]]
    assert "migrate_in" in events and "swap_in" in events
