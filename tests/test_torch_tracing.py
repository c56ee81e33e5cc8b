"""The port's structured trace (``serving/tracing.py`` and the engine's
``start_trace``) against the JAX package's.

On the same traffic (tests/_torch_trace.py: the reduced bnn-lm-100m,
slo with two budgeted tenants, a pool small enough to swap, captured
logits), the two packages' trace files hold the same record sequence
once the timing fields (``ts``, ``dur_s``, ``t0``) are set aside: record
types, step kinds and their prefill/decode infos, per-step actions,
request events with their extras (the port's ``admit`` carries the
request's slot besides), span names with rid, blocks and bytes; the
meta record has JAX's keys and config; captured logits agree within
1e-4 (float32).  ``validate_trace`` rejects what JAX's rejects, with the
same message.  The port's own contract: every record survives a JSON
round trip, the step records' ``dur_s`` sum to ``stats()["wall_s"]``
exactly and the swap spans to the swap section's times, tracing changes
no token, and with tracing off nothing emits a record or takes a
counter snapshot (the allocation guard of tests/test_tracing.py)."""
import json

import numpy as np
import pytest
import torch

import _torch_trace as TT
from repro.serving import tracing as JT
from repro_torch.serving import Engine, EngineConfig, Tracer
from repro_torch.serving import tracing as T

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TT.traced_runs(tmp_path_factory.mktemp("trace"))


def test_trace_records_equal_jax(runs):
    jrec = JT.read_trace(runs["jax"][2])
    trec = T.read_trace(runs["torch"][2])
    assert [TT.strip(r) for r in trec[1:]] == [TT.strip(r) for r in jrec[1:]]
    jm, tm = jrec[0], trec[0]
    assert set(tm) == set(jm)
    assert tm["config"] == jm["config"]
    assert set(tm["engine"]) == set(jm["engine"])
    for key in ("schema", "arch", "accelerator", "spec_k", "shard",
                "n_shards", "role", "link_gbps"):
        assert tm[key] == jm[key], key
    for key, v in jm["engine"].items():
        if not key.endswith("_impl"):
            assert tm["engine"][key] == v, key
    # the traffic made every kind of record the slo run can make
    kinds = {r["kind"] for r in trec if r["type"] == "step"}
    assert {"prefill", "decode", "prefill+decode"} <= kinds
    events = {r["event"] for r in trec if r["type"] == "request"}
    assert {"submit", "admit", "defer", "swap_out", "swap_in", "finish",
            "first_token"} <= events
    assert any(r.get("reason") == "tenant_budget" for r in trec)
    spans = [r for r in trec if r["type"] == "span"]
    assert {s["name"] for s in spans} == {"swap_out", "swap_in"}
    assert all("rid" in s and "blocks" in s for s in spans)
    assert any(s["bytes"] > 0 for s in spans if s["name"] == "swap_out")
    assert any(r.get("actions") for r in trec if r["type"] == "step")
    got, want = TT.logits_of(trec), TT.logits_of(jrec)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TT.LOGITS_TOL)


def test_records_are_plain_json_and_ring_equals_file(runs):
    eng, _toks, path = runs["torch"]
    records = T.read_trace(path)
    assert records == eng.tracer.events()      # no tuple, numpy or tensor
    assert json.loads(json.dumps(records)) == records
    assert eng.tracer.path == path and not eng.tracer.enabled


def test_stats_totals_equal_record_sums(runs):
    eng, _toks, path = runs["torch"]
    records = T.read_trace(path)
    st = eng.stats()
    assert sum(r["dur_s"] for r in records if r["type"] == "step") \
        == st["wall_s"]
    for name in ("swap_out", "swap_in"):
        assert sum(r["dur_s"] for r in records if r["type"] == "span"
                   and r["name"] == name) == st["swap"][f"{name}_s"]
    acts = [r.get("actions", {}) for r in records if r["type"] == "step"]
    assert sum(a.get("swap_outs", 0) for a in acts) == st["swap"]["swap_outs"]
    assert sum(a.get("prefix_hits", 0) for a in acts) \
        == st["prefix_cache"]["hits"]


def test_tracing_changes_no_token(runs):
    for a, b in zip(runs["plain"][1], runs["torch"][1], strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(runs["jax"][1], runs["torch"][1], strict=True):
        np.testing.assert_array_equal(a, b)


def test_disabled_tracing_builds_no_records(monkeypatch):
    """Tracing off (the default): no call site emits a record, builds a
    request record or snapshots the step counters."""
    _jp, tp = TT.F.models(TT.ARCH)
    tcfg = TT.F.cfgs(TT.ARCH, "bnn")[1]
    eng = Engine(tp, tcfg, EngineConfig(**TT.ENGINE), device="cpu")
    assert not eng.tracer.enabled and eng.tracer.ring is None

    def boom(*a, **k):
        raise AssertionError("a record was built with tracing off")
    monkeypatch.setattr(Tracer, "emit", boom)
    monkeypatch.setattr(Tracer, "request", boom)
    monkeypatch.setattr(Engine, "_counter_marks", boom)
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(rng.integers(0, tcfg.vocab, 10), 8, tenant="ab"[i % 2])
    eng.run()
    assert eng.tracer.ring is None and eng._step_rec is None
    assert eng.stats()["wall_s"] > 0     # the spans ran all the same


BAD_TRACES = [
    [],
    [{"type": "step", "step": 0, "dur_s": 0.1}],
    [{"type": "meta", "schema": 999}],
    [{"type": "meta", "schema": 4}, {"type": "bogus"}],
    [{"type": "meta", "schema": 4}, {"type": "step", "step": 0}],
    [{"type": "meta", "schema": 4}, {"type": "request", "event": "x"}],
    [{"type": "meta", "schema": 4}, {"type": "span", "dur_s": 1.0}],
    [{"type": "meta"}],
]


@pytest.mark.parametrize("records", BAD_TRACES, ids=range(len(BAD_TRACES)))
def test_validate_trace_rejects_what_jax_rejects(records):
    with pytest.raises(ValueError) as want:
        JT.validate_trace(records)
    with pytest.raises(ValueError) as got:
        T.validate_trace(records)
    assert str(got.value) == str(want.value)


def test_schema_and_valid_minimal_trace_equal_jax():
    assert T.TRACE_SCHEMA_VERSION == JT.TRACE_SCHEMA_VERSION == 4
    assert T.RECORD_TYPES == JT.RECORD_TYPES
    T.validate_trace([{"type": "meta", "schema": 4}])


def test_tracer_spans_ring_and_reset(tmp_path):
    tr = Tracer()
    with tr.span("swap_out", rid=3, blocks=2) as sp:
        sp.extra["bytes"] = 8
    assert tr.span_counts == {"swap_out": 1} and tr.events() == []
    tr.open(str(tmp_path / "t.jsonl"), ring=2)
    tr.meta(arch="x")
    with tr.span("swap_in", rid=4):
        pass
    tr.request(0, "submit", 1, tenant="a")
    tr.close()
    evs = tr.events()
    assert [e["type"] for e in evs] == ["span", "request"]   # ring of 2
    assert evs[0]["rid"] == 4 and "blocks" not in evs[0]
    assert len(T.read_trace(str(tmp_path / "t.jsonl"))) == 3
    tr.emit({"type": "step"})                  # closed: dropped
    assert len(tr.events()) == 2
    tr.reset_spans("swap_in")
    assert set(tr.span_totals) == {"swap_out"}
    tr.reset_spans()
    assert tr.span_totals == {} and tr.span_counts == {}
