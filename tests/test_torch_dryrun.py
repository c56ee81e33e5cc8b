"""The port's dry-run: ``python -m repro_torch.launch.dryrun --all
--both-meshes`` in its own process (it makes 256- and 512-rank fake
process groups, as the JAX dry-run forces 512 host devices in its own),
with no card.

It records 66 cells ok and 14 skipped: JAX's ``cells_for`` runs 33 of
the 40 arch x shape cells, on two meshes (the JAX suite's
``test_dryrun_artifacts_exist_and_pass``).  Every ok cell carries the
step's collective record with the keys of JAX's ``analyze_collectives``,
its roofline's collective term from it, and the step's temp bytes.  One
cell per family holds
the partition specs that JAX's ``logical_to_pspec`` gives JAX's specs,
and bytes per device that follow from them."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES, cells_for as jcells
from repro.dist import sharding as JS
from repro.layers.common import logical_to_pspec as j_logical_to_pspec
from repro.models import transformer as JM
from repro.launch.hlo_analysis import COLLECTIVES as KINDS
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.analytic import LINK_BW
from repro_torch.launch.mesh import smoke_mesh

from _torch_partition import FakeMesh, flat_jax, unstack_layers

REPO = Path(__file__).resolve().parents[1]
# one cell per family: (arch, shape, multi_pod)
FAMILY_CELLS = (("llama3.2-3b", "train_4k", False),
                ("mixtral-8x7b", "decode_32k", True),
                ("deepseek-v2-lite-16b", "train_4k", True),
                ("mamba2-1.3b", "long_500k", False),
                ("jamba-1.5-large-398b", "decode_32k", True),
                ("musicgen-large", "prefill_32k", False),
                ("pixtral-12b", "prefill_32k", True))


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--out", str(out)],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    arts = {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}
    return res.stdout, arts


def test_sweep_counts_match_jax_cells_for(sweep):
    stdout, arts = sweep
    n_ok = sum(len(jcells(jconfigs.get_config(a))) for a in
               jconfigs.ARCH_IDS)
    n_all = len(jconfigs.ARCH_IDS) * len(JSHAPES)
    assert (n_ok, n_all) == (33, 40)
    status = [a["status"] for a in arts.values()]
    assert status.count("ok") == 2 * n_ok == 66
    assert status.count("skipped") == 2 * (n_all - n_ok) == 14
    assert "[dryrun] ok=66 skipped=14 error=0" in stdout
    for a in arts.values():
        if a["status"] == "skipped":
            assert a["shape"] == "long_500k"
            assert not tconfigs.get_config(a["arch"]).sub_quadratic
            continue
        assert a["devices"] == (512 if a["multi_pod"] else 256)
        coll = a["collectives"]
        assert set(coll) == set(KINDS) | {"total_bytes_static",
                                          "total_bytes_executed"}
        assert all(set(coll[k]) == {"count", "bytes_static",
                                    "bytes_executed"} for k in KINDS)
        assert coll["total_bytes_executed"] >= coll["total_bytes_static"] > 0
        assert a["roofline"]["collective_s"] == \
            coll["total_bytes_executed"] / LINK_BW
        mem = a["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] > 0
        assert mem["output_size_in_bytes"] >= mem["alias_size_in_bytes"]


def _pspec(e):
    return tuple(e) if isinstance(e, list) else e


@pytest.mark.parametrize("arch,shape,multi_pod", FAMILY_CELLS)
def test_family_cell_equals_jax_placements(sweep, arch, shape, multi_pod):
    _stdout, arts = sweep
    art = arts[f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"]
    cell = JSHAPES[shape]
    jcfg = jconfigs.get_config(arch)
    rules = (JS.rules_decode(multi_pod) if cell.kind == "decode"
             else JS.rules_train(multi_pod, fsdp=(cell.kind == "train")))
    mesh = FakeMesh(multi_pod)
    jshapes, jspecs = JM.abstract_init(jcfg)
    want = flat_jax(jcfg, jspecs, jshapes)
    got = {tuple(int(k) if k.isdigit() else k for k in p.split(".")): s
           for p, s in art["pspecs"]["params"].items()}
    assert got.keys() == want.keys()
    n_dev = math.prod(mesh.shape.values())
    param_bytes = 0
    for path, (axes, shp) in want.items():
        spec = tuple(j_logical_to_pspec(axes, rules, shp, mesh))
        assert tuple(_pspec(e) for e in got[path]) == spec, path
        param_bytes += 2 * math.prod(shp) // _ways(spec, mesh)
    assert art["memory"]["params_bytes"] == param_bytes
    if cell.kind == "train":
        mom = 2 if jcfg.d_model >= 4096 else 4
        assert art["memory"]["opt_state_bytes"] == \
            param_bytes // 2 * mom * 2 + 4
    if cell.kind == "decode":
        cspecs = unstack_layers({"segments": JM.cache_specs(jcfg)}, jcfg,
                                True)
        caches = jax.eval_shape(lambda: JM.init_cache(
            jcfg, cell.global_batch, cell.seq_len))
        cshapes = unstack_layers({"segments": caches}, jcfg, False)
        cache_bytes = 0
        for i, (s, x) in enumerate(zip(cspecs, cshapes, strict=True)):
            for k in s:
                spec = tuple(j_logical_to_pspec(tuple(s[k]), rules, x[k],
                                                mesh))
                assert tuple(_pspec(e) for e in
                             art["pspecs"]["cache"][f"{i}.{k}"]) == spec
                cache_bytes += 2 * math.prod(x[k]) // _ways(spec, mesh)
        assert art["memory"]["cache_bytes"] == cache_bytes
    assert art["analytic"]["flops_per_device"] == \
        art["analytic"]["flops_total"] / n_dev


def _ways(spec, mesh) -> int:
    n = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                n *= mesh.shape[a]
    return n


def test_smoke_mesh_cell_bytes_are_the_params_at_bf16():
    """On a 1x1 mesh every leaf is whole: the per-device parameter bytes
    are the trainable tree's at bf16 (the card's [analytic] (d) checks
    the same number against the allocator)."""
    from repro_torch.models import transformer as M
    cfg = tconfigs.get_config("bnn-lm-100m")
    with smoke_mesh("cpu") as mesh:
        res = dryrun.run_cell("bnn-lm-100m", "train_4k", False, mesh=mesh)
    assert not torch.distributed.is_initialized()
    n = sum(x.numel() for x in _leaves(M.trainable(M.abstract_init(cfg),
                                                   cfg)))
    assert res["memory"]["params_bytes"] == 2 * n
    assert res["devices"] == 1


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t
