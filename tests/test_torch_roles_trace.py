"""The per-shard traces of a 1:2 topology, and the front-end over a
``ShardedEngine``, against the JAX package.

A JAX ``ShardedEngine`` and the port's (roles 1:2, the reduced
bnn-lm-100m) serve the same prompts, each traced into
``{prefix}.shard{i}.jsonl``.  Each shard's file: its meta (schema,
shard, n_shards, role, link) and records equal JAX's apart from timing
(the step records with their role, the handoff_out/handoff_in spans
with handoff_id, peer, bytes and the modelled transfer_s, the swap
spans), and it validates in both packages; each shard's photonic replay
and its handoff section equal JAX's; the merged Perfetto export has one
handoff flow per handoff, as JAX's export of JAX's files.  The asyncio
front-end drives a ``ShardedEngine`` (the JAX front-end's duck typing:
the sharded engine has no scheduler of its own; before the port's
front-end took it, ``Frontend(ShardedEngine)`` raised where JAX's
streams): each stream equals the batch run's tokens."""
import asyncio
import json

import pytest

import _torch_shards as H
import _torch_trace as TT
from repro.launch import trace_view as JV
from repro.serving import replay as JRP
from repro.serving import tracing as JT
from repro_torch.launch import trace_view as V
from repro_torch.serving import Frontend
from repro_torch.serving import replay as RP
from repro_torch.serving import tracing as T

ARCH = "bnn-lm-100m"
LENS, MAX_NEW = [4, 7, 8, 5], 6


@pytest.fixture(scope="module")
def runs(bnn_cfg, bnn_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shards")
    tcfg, tp = H.port_model(ARCH, bnn_params)
    ps = H.prompts(bnn_cfg.vocab, LENS, seed=47)
    out = {}
    for side in ("jax", "torch"):
        se = (H.jax_sharded(bnn_cfg, bnn_params, 3, "1:2") if side == "jax"
              else H.port_sharded(tcfg, tp, 3, "1:2"))
        prefix = str(tmp / side)
        se.start_trace(prefix)
        rids = [se.submit(p, MAX_NEW) for p in ps]
        got = se.run()
        se.stop_trace()
        out[side] = (se, prefix, [got[r] for r in rids])
    return out, (tcfg, tp), ps


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_shard_traces_equal_jax(runs, shard):
    out, _m, _ps = runs
    jrec = JT.read_trace(f"{out['jax'][1]}.shard{shard}.jsonl")
    path = f"{out['torch'][1]}.shard{shard}.jsonl"
    trec = T.read_trace(path)
    T.validate_trace(trec)
    JT.validate_trace(JT.read_trace(path))
    assert [TT.strip(r) for r in trec[1:]] == [TT.strip(r) for r in jrec[1:]]
    tm, jm = trec[0], jrec[0]
    for key in ("schema", "arch", "accelerator", "spec_k", "shard",
                "n_shards", "role", "link_gbps"):
        assert tm[key] == jm[key], key
    assert (tm["shard"], tm["n_shards"], tm["role"]) == \
        (shard, 3, ["prefill", "decode", "decode"][shard])
    assert all(r["role"] == tm["role"] and r["shard"] == shard
               for r in trec if r["type"] == "step")


def test_handoff_spans_pair_up(runs):
    out, _m, ps = runs
    se, prefix, _toks = out["torch"]
    spans = [r for i in range(3)
             for r in T.read_trace(f"{prefix}.shard{i}.jsonl")
             if r["type"] == "span" and r["name"].startswith("handoff")]
    outs = {s["handoff_id"]: s for s in spans if s["name"] == "handoff_out"}
    ins = {s["handoff_id"]: s for s in spans if s["name"] == "handoff_in"}
    assert sorted(outs) == sorted(ins) == list(range(len(ps)))
    for hid, s in ins.items():
        assert s["bytes"] == outs[hid]["bytes"] > 0 and s["transfer_s"] > 0
        assert s["rid"] == outs[hid]["rid"] and s["peer"] == 0
    assert sum(s["bytes"] for s in ins.values()) == se.handoff_bytes


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_shard_replays_equal_jax(runs, bnn_cfg, shard):
    out, (tcfg, _tp), ps = runs
    got = RP.replay_trace(f"{out['torch'][1]}.shard{shard}.jsonl", cfg=tcfg)
    want = JRP.replay_trace(f"{out['jax'][1]}.shard{shard}.jsonl",
                            cfg=bnn_cfg)
    assert got == want
    assert RP.format_report(got) == JRP.format_report(want)
    ho = got["handoff"]
    if shard == 0:
        assert got["role"] == "prefill" and ho["handoffs_out"] == len(ps)
    else:
        assert got["role"] == "decode" and ho["bytes_in"] > 0


def test_replays_hand_every_request_in(runs, bnn_cfg):
    out, (tcfg, _tp), ps = runs
    prefix = out["torch"][1]
    assert sum(RP.replay_trace(f"{prefix}.shard{i}.jsonl",
                               cfg=tcfg)["handoff"]["handoffs_in"]
               for i in (1, 2)) == len(ps)


def test_merged_perfetto_view_has_a_flow_per_handoff(runs, tmp_path):
    out, _m, ps = runs
    docs = {}
    for side, mod in (("torch", V), ("jax", JV)):
        dst = str(tmp_path / f"{side}.json")
        mod.export_perfetto_merged(out[side][1], dst)
        docs[side] = json.load(open(dst))
    flows = {side: sorted((e["ph"], e["id"]) for e in d["traceEvents"]
                          if e.get("cat") == "handoff")
             for side, d in docs.items()}
    assert flows["torch"] == flows["jax"]
    assert sorted(i for ph, i in flows["torch"] if ph == "s") == \
        sorted(i for ph, i in flows["torch"] if ph == "f") == \
        list(range(len(ps)))
    assert docs["torch"]["otherData"]["roles"] == \
        {"0": "prefill", "1": "decode", "2": "decode"}


def test_tokens_equal_jax(runs):
    out, _m, _ps = runs
    H.assert_same_tokens(out["torch"][2], out["jax"][2])


def test_front_end_streams_over_a_sharded_engine(runs):
    out, (tcfg, tp), ps = runs
    se = H.port_sharded(tcfg, tp, 3, "1:2")
    assert not hasattr(se, "scheduler")

    async def go():
        got = {}
        async with Frontend(se) as fe:
            rids = [fe.submit(p, MAX_NEW) for p in ps]

            async def consume(rid):
                got[rid] = [t async for burst in fe.stream(rid)
                            for t in burst]
            await asyncio.gather(*(consume(r) for r in rids))
        return rids, got
    # a front-end that cannot drive the engine leaves the streams waiting:
    # a bound turns that into a failure (the run takes well under 1 s)
    rids, got = asyncio.run(asyncio.wait_for(go(), timeout=30))
    want = out["torch"][2]
    for b, rid in enumerate(rids):
        assert got[rid] == list(want[b][len(ps[b]):])
    assert se.idle and se.handoffs == len(ps)
