"""The port's three examples, run with ``--device cpu``, print the
numbers of their JAX originals.

``quickstart_torch`` prints the JAX quickstart's numbers (Table II, the
VDP three ways on the JAX quickstart's own bits, the Fig. 5 mappings);
``photonic_sim_demo_torch`` prints the JAX demo's lines, then one line
of its own (a simulated conv layer through the port's binarized conv);
``multiarch_dryrun_torch`` prints the record of its default cell,
whose devices, per-device parameter and cache bytes and analytic
counts are the ones JAX's specs and analytic model give (the JAX
example compiles the cell on 256 host devices; its XLA-only fields,
cost analysis and collectives, have no counterpart)."""
import json
import math
import re
import runpy
from pathlib import Path

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.dist import sharding as JS
from repro.launch import analytic as janalytic
from repro.layers.common import logical_to_pspec as j_logical_to_pspec
from repro.models import transformer as JM

from _torch_partition import FakeMesh, flat_jax, unstack_layers

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUM = re.compile(r"-?\d+(?:\.\d+)?")


def _run(name: str, capsys, *argv) -> str:
    mod = runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="example")
    capsys.readouterr()
    mod["main"](*argv)
    return capsys.readouterr().out


def test_quickstart_prints_the_jax_numbers(capsys):
    want = _run("quickstart", capsys)
    got = _run("quickstart_torch", capsys, ["--device", "cpu"])
    assert NUM.findall(got) == NUM.findall(want)
    assert "bitcount: optical(PCA)=" in got and "kernel(cpu)=" in got


def test_photonic_demo_prints_the_jax_lines(capsys):
    want = _run("photonic_sim_demo", capsys)
    got = _run("photonic_sim_demo_torch", capsys, ["--device", "cpu"])
    head, tail = got.split("\nVGG-small conv2 on cpu:")
    assert head.rstrip("\n") == want.rstrip("\n")
    assert tail.strip() == ("131072 outputs, the binarized conv == the "
                            "sign-conv reference: True")


def _ways(spec, mesh) -> int:
    n = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                n *= mesh.shape[a]
    return n


def test_multiarch_dryrun_prints_the_jax_cell(capsys):
    got = json.loads(_run("multiarch_dryrun_torch", capsys,
                          ["--device", "cpu"]))
    assert not torch.distributed.is_initialized()
    arch, shape = "qwen1.5-0.5b", "decode_32k"
    assert (got["arch"], got["shape"], got["multi_pod"], got["status"]) \
        == (arch, shape, False, "ok")
    jcfg, cell = jconfigs.get_config(arch), JSHAPES[shape]
    mesh = FakeMesh(False)
    assert got["devices"] == math.prod(mesh.shape.values()) == 256
    rules = JS.rules_decode(False)
    jshapes, jspecs = JM.abstract_init(jcfg)
    params = sum(2 * math.prod(shp) // _ways(tuple(j_logical_to_pspec(
        axes, rules, shp, mesh)), mesh)
        for axes, shp in flat_jax(jcfg, jspecs, jshapes).values())
    cspecs = unstack_layers({"segments": JM.cache_specs(jcfg)}, jcfg, True)
    cshapes = unstack_layers({"segments": jax.eval_shape(
        lambda: JM.init_cache(jcfg, cell.global_batch, cell.seq_len))},
        jcfg, False)
    caches = sum(2 * math.prod(x[k]) // _ways(tuple(j_logical_to_pspec(
        tuple(s[k]), rules, x[k], mesh)), mesh)
        for s, x in zip(cspecs, cshapes) for k in s)
    assert got["memory"]["params_bytes"] == params
    assert got["memory"]["cache_bytes"] == caches
    cm = janalytic.cell_model(jcfg, cell)
    for f in ("flops_fwd", "flops_total", "hbm_bytes", "model_flops",
              "params_total", "params_active"):
        assert got["analytic"][f] == pytest.approx(getattr(cm, f),
                                                   rel=1e-12)
