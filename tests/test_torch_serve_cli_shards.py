"""The port's serve CLI with ``--shards`` (and ``--roles``) against the
JAX CLI, on the JAX CLI's reduced parameters and prompts at its default
sizes (4 requests of 16 tokens, 16 new).  This file: ``--shards 2``
(mixed); tests/test_torch_serve_cli_roles.py: ``--shards 3 --roles 1:2
--trace PREFIX --replay-photonic``.  The returned tokens and every
printed line equal the JAX CLI's apart from timing fields (tokens/s,
host-copy wall ms) and the trace viewer's module name: the per-shard
rows, the aggregate line, the handoff line and each shard's replay
report.  (One JAX CLI run a file: each builds a jitted JAX engine a
shard.)"""
import contextlib
import io
import re

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.layers import common as JC
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as S

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"
SIZE = dict(batch=4, prompt_len=16, gen=16)
CASES = {"2": dict(shards=2)}
TIMING = (re.compile(r"tokens/s=[0-9.]+"), re.compile(r"wall [0-9.]+ms"),
          re.compile(r"\S+ \(view: python -m \S+ \S+\)"))


def _untimed(lines):
    out = []
    for ln in lines:
        for pat in TIMING:
            ln = pat.sub("#", ln)
        out.append(ln)
    return out


def cli_outputs(cases, tmp):
    """{(case, "jax"|"torch"): (tokens, stdout lines, trace prefix)}: each
    case's flags through both CLIs (a case with ``roles`` also traced
    under ``tmp``)."""
    try:
        jcfg, jp, _mesh = jserve._setup(ARCH, True, False, "bnn", 0)
        prompts = np.asarray(jserve._prompts(jcfg, SIZE["batch"],
                                             SIZE["prompt_len"], 0))
    finally:
        JC.clear_sharding_context()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           S._config(ARCH, True, "bnn"))
    out = {}
    for case, flags in cases.items():
        for side in ("jax", "torch"):
            buf = io.StringIO()
            kw = dict(flags)
            if "roles" in flags:
                kw["trace"] = str(tmp / side)
            with contextlib.redirect_stdout(buf):
                if side == "jax":
                    toks = jserve.serve(ARCH, smoke=True, precision="bnn",
                                        **SIZE, **kw)
                else:
                    toks = S.serve(ARCH, smoke=True, precision="bnn",
                                   **SIZE, **kw, device="cpu", params=tp,
                                   prompts=prompts)
            out[case, side] = (toks, buf.getvalue().splitlines(),
                               kw.get("trace"))
    return out


def check_case(outputs, case, flags):
    jtoks, jlines, _ = outputs[case, "jax"]
    ttoks, tlines, _ = outputs[case, "torch"]
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert _untimed(tlines) == _untimed(jlines)
    shards = flags["shards"]
    rows = [ln for ln in tlines if ln.startswith("[serve] shard ")]
    assert len(rows) == shards
    assert any(f"shards={shards} batch=4 aggregate" in ln for ln in tlines)
    handoffs = [ln for ln in tlines if ln.startswith("[serve] handoffs=")]
    assert len(handoffs) == ("roles" in flags)
    if "roles" in flags:
        assert rows[0].startswith("[serve] shard 0 (prefill)")
        assert sum(ln.startswith("[replay] role=") for ln in tlines) == shards


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return cli_outputs(CASES, tmp_path_factory.mktemp("cli_shards"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_cli_output_equals_jax_cli(outputs, case):
    check_case(outputs, case, CASES[case])
