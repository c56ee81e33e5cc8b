"""The analytic FLOP / byte model against the JAX package's, and
against torch's own FLOP counter.

For bnn-lm-100m and every id of ``ARCH_IDS``, at published and at
reduced width, and for every cell of ``cells_for`` plus a train, a
prefill and a decode probe cell, every field of the port's
``cell_model`` equals JAX's within a relative 1e-12; ``roofline_terms``
equal JAX's once scaled by the ratios of the two packages' hardware
constants (H100 against TPU v5e).  ``FlopCounterMode`` takes the place
of XLA's cost analysis in the per-layer cross-check (the JAX suite's
``test_forward_flops_vs_cost_analysis_dense``, 15 %)."""
import functools

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.configs.base import ShapeCell as JShapeCell, cells_for as jcells
from repro.configs.base import reduced as jreduced
from repro.launch import analytic as janalytic
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeCell, cells_for, reduced
from repro_torch.launch import analytic
from repro_torch.models import transformer as M

torch.set_num_threads(1)

ARCHS = ["bnn-lm-100m"] + list(jconfigs.ARCH_IDS)
PROBES = (("probe_train", 64, 4, "train"), ("probe_prefill", 128, 2,
                                             "prefill"),
          ("probe_decode", 300, 3, "decode"))
FIELDS = ("flops_fwd", "flops_total", "hbm_bytes", "model_flops",
          "params_total", "params_active")
# the TPU v5e constants of the JAX package's model, over the port's
SCALE = {"compute_s": janalytic.PEAK_FLOPS / analytic.PEAK_FLOPS,
         "memory_s": janalytic.HBM_BW / analytic.HBM_BW,
         "collective_s": janalytic.ICI_BW / analytic.LINK_BW}


@pytest.fixture(scope="module", autouse=True)
def jax_params_once():
    """JAX's ``_params`` traces ``abstract_init`` on every call; the
    test asks it once a config."""
    real = janalytic._params
    janalytic._params = functools.lru_cache(maxsize=None)(real)
    yield
    janalytic._params = real


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("width", ["published", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_model_equals_jax(arch, width):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if width == "reduced":
        jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
    tcells = cells_for(tcfg)
    assert [c.name for c in tcells] == [c.name for c in jcells(jcfg)]
    cells = [(c, JShapeCell(c.name, c.seq_len, c.global_batch, c.kind))
             for c in tcells]
    cells += [(ShapeCell(*p), JShapeCell(*p)) for p in PROBES]
    for tc, jc in cells:
        for kw in ({}, {"microbatches": 2, "remat": False}):
            got = analytic.cell_model(tcfg, tc, **kw)
            want = janalytic.cell_model(jcfg, jc, **kw)
            for f in FIELDS:
                assert _rel(getattr(got, f), getattr(want, f)) <= 1e-12, \
                    (tc.name, kw, f, getattr(got, f), getattr(want, f))
            assert got.notes == want.notes
            for n_dev, coll in ((1, 0.0), (256, 3e9)):
                tr = analytic.roofline_terms(got, coll, n_dev)
                jr = janalytic.roofline_terms(want, coll, n_dev)
                for k, s in SCALE.items():
                    assert _rel(tr[k], jr[k] * s) <= 1e-12, (tc.name, k)
                assert _rel(tr["useful_flops_fraction"],
                            jr["useful_flops_fraction"]) <= 1e-12
                assert tr["step_s_bound"] == max(tr[k] for k in SCALE)
                assert tr["dominant"] + "_s" in SCALE and \
                    tr[tr["dominant"] + "_s"] == tr["step_s_bound"]


def test_tied_head_counts_once():
    cfg = tconfigs.get_config("bnn-lm-100m")
    assert cfg.tie_embeddings
    full = M.abstract_init(cfg)
    n_all = sum(x.numel() for x in _leaves(full))
    total, active = analytic._params(cfg)
    assert total == active == n_all - cfg.vocab * cfg.d_model


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t


def _fwd_flops(cfg, params, tokens) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        torch.sum(M.hidden_states(params, cfg, tokens, impl="torch"))
    return fc.get_total_flops()


def test_forward_flops_vs_flop_counter_dense():
    """Reduced qwen-family forward at bf16 precision: the per-layer FLOPs
    torch counts (the difference of depths 4 and 2, halved) match the
    analytic per-layer count within 15 %, as XLA's count does in the
    JAX suite."""
    cfg = reduced(tconfigs.get_config("qwen1.5-0.5b")).replace(
        q_chunk=64, kv_chunk=64, vocab=512, precision="bf16")
    b, t = 2, 16
    cell = ShapeCell("probe", t, b, "prefill")
    cm = analytic.cell_model(cfg, cell)
    per_layer_analytic = (cm.flops_fwd - 2 * b * cfg.d_model * cfg.vocab) \
        / cfg.n_layers / cell.tokens
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, t)))
    flops = {}
    for depth in (2, 4):
        c = cfg.replace(n_layers=depth)
        p = M.init(torch.Generator().manual_seed(0), c)
        flops[depth] = _fwd_flops(c, p, tokens)
    measured_per_layer = (flops[4] - flops[2]) / 2 / cell.tokens
    assert measured_per_layer == pytest.approx(per_layer_analytic,
                                               rel=0.15), \
        (measured_per_layer, per_layer_analytic)


def test_model_flops_definitions():
    cfg = tconfigs.get_config("mixtral-8x7b")
    cell = ShapeCell("train_4k", 4096, 256, "train")
    cm = analytic.cell_model(cfg, cell)
    # active params far below total for a top-2-of-8 MoE
    assert cm.params_active < 0.45 * cm.params_total
    # 6*N_active*D
    assert cm.model_flops == pytest.approx(
        6.0 * cm.params_active * cell.tokens)
    # executed > useful (remat + attention + dispatch overheads)
    assert cm.flops_total > cm.model_flops


def test_roofline_terms_shape():
    cfg = tconfigs.get_config("llama3.2-3b")
    cell = ShapeCell("train_4k", 4096, 256, "train")
    cm = analytic.cell_model(cfg, cell)
    terms = analytic.roofline_terms(cm, coll_bytes_executed=1e9,
                                    n_devices=256)
    assert set(terms) >= {"compute_s", "memory_s", "collective_s",
                          "dominant", "roofline_fraction"}
    assert terms["dominant"] in ("compute", "memory", "collective")
    assert 0 < terms["useful_flops_fraction"] <= 1.0
