"""Trace interchange between the two packages: the port's photonic
replay (``serving/replay.py``) and Perfetto view (``launch/trace_view``)
against the JAX package's.

The traces are tests/_torch_trace.py's (the same traffic through both
packages' engines).  A JAX-written trace replays in the port to JAX's
report and exports to JAX's Perfetto JSON; a port-written trace loads in
JAX's ``read_trace`` and replays there to the port's report; and since
the two traces' step records are equal, all four reports are one.  The
merged multi-shard view of two shard files, the CLI's output,
``spec_chunk_cap`` and the engine's ``apply_replay_curve`` equal JAX's
too.  The simulator and cost model are the same arithmetic in both
packages (tests/test_torch_photonic.py), so reports compare exactly."""
import json
import shutil

import pytest
import torch

import _torch_trace as TT
from repro.launch import trace_view as JV
from repro.serving import replay as JR
from repro.serving import tracing as JT
from repro_torch.launch import trace_view as V
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving import replay as R
from repro_torch.serving import tracing as T

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TT.traced_runs(tmp_path_factory.mktemp("replay"),
                          capture_logits=False)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_replay_report_equals_jax(runs, writer):
    path = runs[writer][2]
    got = R.replay_trace(path)
    want = JR.replay_trace(JT.read_trace(path))
    assert got == want
    assert R.format_report(got) == JR.format_report(want)
    # the port rebuilds the config a JAX trace was written with
    assert R.load_config(T.read_trace(path)[0]).name == TT.ARCH + "-reduced"
    assert got["finished_requests"] == 9 and got["committed_tokens"] > 0
    assert {"prefill", "decode"} <= set(got["by_kind"])


def test_both_packages_traces_replay_alike(runs):
    assert R.replay_trace(runs["torch"][2]) == R.replay_trace(runs["jax"][2])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_perfetto_export_equals_jax(runs, writer, tmp_path):
    path = runs[writer][2]
    n = V.export_perfetto(path, str(tmp_path / "t.json"))
    jn = JV.export_perfetto(path, str(tmp_path / "j.json"))
    got = json.load(open(tmp_path / "t.json"))
    assert n == jn and got == json.load(open(tmp_path / "j.json"))
    tracks = {e["args"]["name"] for e in got["traceEvents"]
              if e["ph"] == "M" and e["pid"] == V.REQUEST_PID
              and e["name"] == "thread_name"}
    assert tracks == {f"rid {r}" for r in range(9)}


def test_merged_shard_view_equals_jax(runs, tmp_path):
    prefix = str(tmp_path / "run")
    for i, side in enumerate(("jax", "torch")):
        shutil.copy(runs[side][2], f"{prefix}.shard{i}.jsonl")
    assert V.discover_shard_traces(prefix) == \
        JV.discover_shard_traces(prefix)
    assert len(V.discover_shard_traces(prefix + ".shard1.jsonl")) == 2
    n = V.export_perfetto_merged(prefix, str(tmp_path / "m.json"))
    jn = JV.export_perfetto_merged(prefix, str(tmp_path / "jm.json"))
    assert n == jn
    assert json.load(open(tmp_path / "m.json")) == \
        json.load(open(tmp_path / "jm.json"))


def test_trace_view_cli_prints_what_jax_prints(runs, tmp_path, capsys):
    src = str(tmp_path / "cli.jsonl")
    shutil.copy(runs["torch"][2], src)
    V.main([src, "--replay-photonic"])
    got = capsys.readouterr().out
    JV.main([src, "--replay-photonic"])
    want = capsys.readouterr().out
    assert got == want and "[replay]" in got
    V.main([src, "--replay-photonic", "--json"])
    assert json.loads(capsys.readouterr().out.split("\n", 1)[1]) == \
        R.replay_trace(src)


def test_spec_chunk_cap_and_apply_replay_curve_equal_jax(runs):
    curve = R.replay_trace(runs["torch"][2])["decode_batch_curve"]
    assert R.spec_chunk_cap(curve) == JR.spec_chunk_cap(curve)
    assert R.spec_chunk_cap({}) is None
    flat = {"1": {"step_latency_s": 1.0}, "2": {"step_latency_s": 2.5},
            "4": {"step_latency_s": 3.0}}
    assert R.spec_chunk_cap(flat) == JR.spec_chunk_cap(flat) == 1
    steep = {"1": {"step_latency_s": 1.0}, "2": {"step_latency_s": 1.2},
             "4": {"step_latency_s": 1.6}, "8": {"step_latency_s": 9.0}}
    cap = R.spec_chunk_cap(steep)
    assert cap == JR.spec_chunk_cap(steep) == 4
    tcfg = TT.F.cfgs(TT.ARCH, "bnn")[1]
    eng = Engine(runs["torch"][0].params, tcfg,
                 EngineConfig(spec_k=6, prefill_chunk=8), device="cpu")
    assert eng.apply_replay_curve(steep) == cap - 1
    assert eng.scheduler.decode_cost == cap
    assert eng.apply_replay_curve(flat) == 0     # lowers, never raises
    assert eng.apply_replay_curve(steep) == 0
