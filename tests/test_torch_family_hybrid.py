"""Port family: the reduced jamba hybrid (Mamba-2 SSD layers over
recurrent slots, one GQA layer over paged blocks per period of 8, MoE
every 2nd layer, a dense FFN on the others) against the JAX package —
config, parameter conversion, chunked prefill + paged decode logits and
greedy continuations, the full-sequence forward, the composite cache's
all-or-nothing admission against the JAX ``MixerStateCache``, the cost
model, and the window that ``chip_smoke.py`` serves at published width
(published layers 2-4).  The serving engine on the hybrid:
tests/test_torch_hybrid_engine.py and tests/test_torch_hybrid_window.py.  Tolerances in
tests/_torch_family.py."""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.models import transformer as JM
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving.block_cache import MixerStateCache as JCache
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as M
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.block_cache import MixerStateCache
from repro_torch.serving.request import Request

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
S = importlib.util.module_from_spec(_spec)    # its admission records
_spec.loader.exec_module(S)

ARCH = "jamba-1.5-large-398b"
BS, CHUNK = 4, 8
# 2 allocatable slots under a batch of 4 and 9 allocatable blocks (36
# tokens): admissions wait for a slot with blocks free, and find a slot
# with too few blocks; decode growth preempts
ENGINE = dict(block_size=BS, num_blocks=10, max_batch=4, num_slots=3,
              prefill_chunk=CHUNK, max_model_len=64)
PROMPTS = (3, 5, 12, 27, 19, 9, 22, 14)
MAX_NEW = (6, 9, 5, 4, 8, 7, 5, 6)


@pytest.fixture(scope="module")
def models(jamba_models):
    _jcfg, jp = jamba_models
    _j, tcfg = F.cfgs(ARCH, "bnn")
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)


@pytest.fixture(scope="module")
def runs(models):
    return F.model_runs(ARCH, *models, prompt_len=21, chunk=CHUNK, bs=BS,
                        table_width=8, ring=False, slot=2)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, n) for n in PROMPTS]


def _watched_pair(arch_cfgs, jp, tp, ecfg_kw, prompts, max_new):
    """Both engines on the same traffic, each cache's admissions recorded
    (``chip_smoke.watch_admissions``) from its first request."""
    jcfg, tcfg = arch_cfgs
    je = JEngine(jp, jcfg, JEngineConfig(
        **ecfg_kw, prefix_cache=False, preempt_policy="recompute",
        attn_impl="xla", bnn_impl="xla"))
    te = Engine(tp, tcfg, EngineConfig(
        **ecfg_kw, prefix_cache=False, preempt_policy="recompute"),
        device="cpu")
    recs = [S.watch_admissions(je), S.watch_admissions(te)]
    served = [(e, F.drive(e, prompts, max_new, late=2, late_after=3))
              for e in (je, te)]
    return served[0], served[1], recs


@pytest.mark.parametrize("shrink", [False, True])
def test_config_matches_jax(shrink):
    F.check_config(ARCH, shrink)


def test_params_from_numpy_round_trip(models):
    """The period of 8 mixes ssm/gqa mixers and dense/moe FFNs under
    ``l{i}`` keys; each layer comes back in plan order."""
    F.check_round_trip(ARCH, *models)
    _jp, tp = models
    _j, tcfg = F.cfgs(ARCH, "bnn")
    plan = M.layer_plan(tcfg)
    assert plan[3] == ("gqa", "moe") and plan[2] == ("ssm", "dense")
    assert plan[1] == ("ssm", "moe")
    for (mix, f), p in zip(plan, tp["layers"]):
        assert ("in_proj" in p["attn"]) == (mix == "ssm")
        assert ("router" in p["ffn"]) == (f == "moe")


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_prefill_and_decode_logits_match_jax(runs, precision):
    (lj, _), (lt, _) = runs[precision]["jax"], runs[precision]["torch"]
    assert lt.shape == lj.shape == (21 + 8, 128)
    np.testing.assert_allclose(lt, lj, **F.TOL)


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_greedy_continuation_matches_jax(runs, precision):
    assert runs[precision]["torch"][1] == runs[precision]["jax"][1]


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_full_sequence_forward_matches_jax(models, precision):
    """The MoE layers at the config's finite capacity, three SSD chunks
    of 8 (the last padded)."""
    F.check_logits_fn(ARCH, *models, precision, t=20)


# --------------------------------------------- the composite's admission


def _caches(num_blocks):
    jcfg, tcfg = F.cfgs(ARCH, "bnn")
    kw = dict(num_blocks=num_blocks, block_size=BS, max_model_len=64,
              num_slots=3, prefill_chunk=CHUNK)
    return (JCache(jcfg, **kw, prefix_cache=False),
            MixerStateCache(tcfg, **kw, prefix_cache=False))


def _state(cache, req, ok):
    return (ok, cache.ssm.allocator.num_free, cache.attn.allocator.num_free,
            req.pos, req.slot, list(req.blocks))


def _script(case):
    """(num_blocks, [(op, request index, argument)]) of each case."""
    if case == "no_slot":            # both slots taken: nothing allocated
        return 12, [("alloc", 0, 8), ("alloc", 1, 4), ("alloc", 2, 4)]
    if case == "slot_but_no_blocks":  # the slot goes back, pos 0
        return 5, [("alloc", 0, 12), ("alloc", 1, 8), ("alloc", 1, 8)]
    if case == "release_frees_both":
        return 9, [("alloc", 0, 12), ("alloc", 1, 8), ("alloc", 2, 16),
                   ("release", 0, 0), ("alloc", 2, 16), ("release", 1, 0),
                   ("release", 2, 0)]
    if case == "ensure_short_of_a_slot":   # preempted: no slot to regrow
        return 12, [("alloc", 0, 4), ("alloc", 1, 4), ("release", 2, 0),
                    ("ensure", 2, 4)]
    # short of blocks: the request keeps its slot and its blocks
    return 6, [("alloc", 0, 8), ("alloc", 1, 8), ("ensure", 0, 13),
               ("ensure", 0, 12)]


@pytest.mark.parametrize("case", ["no_slot", "slot_but_no_blocks",
                                  "release_frees_both",
                                  "ensure_short_of_a_slot",
                                  "ensure_short_of_blocks"])
def test_composite_admission_matches_jax(case):
    num_blocks, script = _script(case)
    states = []
    for cache, req_cls in zip(_caches(num_blocks), (JRequest, Request)):
        reqs = {}
        out = []
        for op, i, n in script:
            if i not in reqs:
                reqs[i] = req_cls(i, np.arange(n, dtype=np.int32), 4)
            req = reqs[i]
            if op == "alloc":
                ok = cache.alloc_prompt(req)
            elif op == "ensure":
                ok = cache.ensure_capacity(req, n)
            else:
                cache.release(req)
                ok = None
            out.append(_state(cache, req, ok))
        cache.attn.allocator.check()
        cache.ssm.allocator.check()
        states.append(out)
    jstates, tstates = states
    assert tstates == jstates
    oks = [s[0] for s in tstates if s[0] is not None]
    assert False in oks
    if case == "slot_but_no_blocks":
        # the failed admission leaves the request without slot or blocks
        # and both members as before it
        assert tstates[1][1:] == (1, 1, 0, None, [])
        assert tstates[1][1:3] == tstates[0][1:3]
    if case == "release_frees_both":
        assert tstates[-1][1:3] == (2, 8)


# ---------------------------------------------------- the served window


def _window_cfgs():
    """The smoke's window (published layers 2-4) at reduced width, in
    both packages."""
    from repro import configs as jconfigs
    from repro.configs.base import reduced as jreduced
    j = S.jamba_window(jreduced(jconfigs.get_config(ARCH))).replace(
        precision="bnn")
    t = S.jamba_window(reduced(get_config(ARCH))).replace(precision="bnn")
    return j, t


def test_window_cut_is_published_layers_2_to_4():
    from repro import configs as jconfigs
    full = jconfigs.get_config(ARCH)
    window = S.jamba_window(get_config(ARCH))
    assert M.layer_plan(window) == JM.layer_plan(full)[2:5] == [
        ("ssm", "dense"), ("gqa", "moe"), ("ssm", "dense")]
    # every width as published: only the depth and the period move
    assert window.replace(n_layers=72, attn_offset=3, scan_period=8) == \
        get_config(ARCH)
    assert M.segments(window) == [("scan", M.layer_plan(window), 1)]


@pytest.mark.parametrize("which", ["reduced", "window", "published"])
def test_cost_model_prices_the_hybrid_as_jax(which):
    """The photonic cost model's GEMM list and reports of the hybrid
    (its SSD, attention, dense and MoE layers) equal the JAX package's,
    at reduced width, for the served window and for all 72 layers."""
    import dataclasses

    from repro import configs as jconfigs
    from repro.configs.base import reduced as jreduced
    from repro.serving import cost_model as jcm
    from repro_torch.serving import cost_model as cm
    j, t = jconfigs.get_config(ARCH), get_config(ARCH)
    if which == "reduced":
        j, t = jreduced(j), reduced(t)
    elif which == "window":
        j, t = S.jamba_window(j), S.jamba_window(t)
    assert [dataclasses.asdict(x) for x in cm.gemm_specs(t)] == \
        [dataclasses.asdict(x) for x in jcm.gemm_specs(j)]
    got = cm.PhotonicCostModel(t, "OXBNN_50", fused_bnn=True)
    want = jcm.PhotonicCostModel(j, "OXBNN_50", fused_bnn=True)
    assert got.report() == want.report()
    kw = dict(prefill_tokens=9000, decode_tokens=384, prefill_passes=80,
              prefill_chunk=128)
    assert got.serving_report(**kw) == want.serving_report(**kw)


def test_chip_profile_serves_the_smokes_jamba_window():
    """``chip_profile.py --arch jamba-1.5-large-398b`` profiles what the
    smoke's jamba phase serves: the window, its engine and traffic."""
    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_profile",
                                                  repo / "chip_profile.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    cfg, ecfg, prompts, max_new, n_late, late_after, kernels = \
        prof._workload(ARCH)
    assert cfg == S.jamba_window(get_config(ARCH).replace(precision="bnn"))
    assert ecfg == EngineConfig(**S.JAMBA_ENGINE)
    assert [len(p) for p in prompts] == \
        [len(p) for p in S.jamba_traffic(cfg.vocab)]
    assert (max_new, n_late, late_after) == (32, 4, 4)
    assert set(kernels) == {"fused_bnn", "paged_attention", "binarize_pack",
                            "row_gemm", "row_norm"}
