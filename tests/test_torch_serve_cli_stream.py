"""The port's serve CLI with the flags of the policies, the trace and the
front-end, against the JAX CLI (tests/test_torch_serve_cli.py gives both
the JAX CLI's reduced parameters and prompts).

``--tenants "a=latency:256,b=throughput" --stream --score 2
--cancel-after 4 --trace PATH --replay-photonic`` at the CLI's default
sizes (4 requests of 16 tokens, 16 new): the returned tokens, every
``[serve:stream]`` line (rid, tenant, class, tokens streamed, the
cancelled request), the scoring lines (ppl within 1e-3) and the whole
replay report equal the JAX CLI's; the trace file validates in both
packages.  The same flags through ``main`` with ``--device cpu``, and
the policy default (slo with tenants, else fcfs)."""
import re

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.layers import common as JC
from repro.serving import tracing as JT
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as S
from repro_torch.serving import tracing as T

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"
SIZE = dict(batch=4, prompt_len=16, gen=16)
FLAGS = dict(tenants="a=latency:256,b=throughput", stream=True, score=2,
             cancel_after=4, replay_photonic=True)
SCORE_LINE = re.compile(r"\[serve:stream\] score rid=(\d+) tokens=(\d+) "
                        r"ppl=([0-9.]+)")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(JAX CLI's tokens and stdout, the port's), both with a trace."""
    import contextlib
    import io
    tmp = tmp_path_factory.mktemp("cli")
    try:
        jcfg, jp, _mesh = jserve._setup(ARCH, True, False, "bnn", 0)
        prompts = np.asarray(jserve._prompts(jcfg, SIZE["batch"],
                                             SIZE["prompt_len"], 0))
    finally:
        JC.clear_sharding_context()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           S._config(ARCH, True, "bnn"))
    out = {}
    for side in ("jax", "torch"):
        buf = io.StringIO()
        trace = str(tmp / f"{side}.jsonl")
        with contextlib.redirect_stdout(buf):
            if side == "jax":
                toks = jserve.serve(ARCH, smoke=True, precision="bnn",
                                    **SIZE, **FLAGS, trace=trace)
            else:
                toks = S.serve(ARCH, smoke=True, precision="bnn", **SIZE,
                               **FLAGS, trace=trace, device="cpu",
                               params=tp, prompts=prompts)
        out[side] = (toks, buf.getvalue().splitlines(), trace)
    return out


def test_stream_flags_equal_jax_cli(outputs):
    (jtoks, jlines, _), (ttoks, tlines, _) = outputs["jax"], outputs["torch"]
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert ttoks.shape == (SIZE["batch"] - 1, 32)       # one cancelled

    def stream(lines):
        return [ln for ln in lines if ln.startswith("[serve:stream] rid=")]
    assert stream(tlines) == stream(jlines)
    assert len(stream(tlines)) == SIZE["batch"]
    assert stream(tlines)[-1].endswith("streamed=4 CANCELLED")
    assert "tenant=b class=throughput" in stream(tlines)[1]
    got = [SCORE_LINE.match(ln).groups() for ln in tlines
           if SCORE_LINE.match(ln)]
    want = [SCORE_LINE.match(ln).groups() for ln in jlines
            if SCORE_LINE.match(ln)]
    assert len(got) == len(want) == FLAGS["score"]
    for (rid, n, ppl), (jrid, jn, jppl) in zip(got, want):
        assert (rid, n) == (jrid, jn) == (rid, str(SIZE["prompt_len"] - 1))
        assert abs(float(ppl) - float(jppl)) <= 1e-3 * float(jppl)

    def replay(lines):
        return [ln for ln in lines if ln.startswith("[replay]")
                or re.match(r"(kind|prefill|decode|TOTAL) ", ln)]
    assert replay(tlines) == replay(jlines)
    assert len(replay(tlines)) >= 5


def test_trace_file_validates_in_both_packages(outputs):
    path = outputs["torch"][2]
    records = T.read_trace(path)
    assert JT.read_trace(path) == records
    meta = records[0]
    assert meta["engine"]["policy"] == "slo"
    assert meta["engine"]["tenants"] == "a=latency:256,b=throughput:0"
    subs = [r for r in records if r.get("event") == "submit"]
    assert [(r["tenant"], r["slo_class"]) for r in subs[:4]] == [
        ("a", "latency"), ("b", "throughput")] * 2
    assert sum(r.get("event") == "cancelled" for r in records) == 1
    assert sum(bool(r.get("prefill", {}).get("score")) for r in records
               if r["type"] == "step") == 2


def test_main_takes_the_new_flags(tmp_path, capsys):
    trace = str(tmp_path / "m.jsonl")
    toks = S.main(["--smoke", "--precision", "bnn", "--device", "cpu",
                   "--tenants", "a=latency:256,b=throughput", "--stream",
                   "--score", "2", "--cancel-after", "4", "--trace", trace,
                   "--replay-photonic"])
    assert toks.shape == (3, 32)
    text = capsys.readouterr().out
    assert "CANCELLED" in text and "[replay]" in text
    assert "python -m repro_torch.launch.trace_view" in text
    T.read_trace(trace)


@pytest.mark.parametrize("tenants,policy,want", [
    ("", None, "fcfs"), ("a=latency", None, "slo"),
    ("a=latency", "priority", "priority")])
def test_policy_default_follows_tenants(monkeypatch, tenants, policy, want):
    seen = {}
    real = S.run

    def spy(params, cfg, prompts, gen, ecfg, **kw):
        seen["policy"] = ecfg.policy
        return real(params, cfg, prompts, gen, ecfg, **kw)
    monkeypatch.setattr(S, "run", spy)
    S.serve(ARCH, smoke=True, precision="bnn", batch=2, prompt_len=8, gen=2,
            tenants=tenants, policy=policy, device="cpu", verbose=False)
    assert seen["policy"] == want
