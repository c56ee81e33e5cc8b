"""Port family: reduced deepseek-v2-lite (MLA over paged latent pools +
MoE with shared experts + a leading dense layer of width dense_d_ff)
against the JAX package — config, parameter conversion (the unrolled
leading segment and the scan-stacked MoE layers), chunked prefill +
paged decode logits, greedy continuations, the full-sequence forward,
and the serving engine's greedy tokens under mid-stream admission and
recompute preemption.  Tolerances in tests/_torch_family.py."""
import numpy as np
import pytest
import torch

import _torch_family as F

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
# 13 allocatable blocks: the first three prompts fit (4 + 3 + 5 blocks),
# their growth does not, so the scheduler preempts
ENGINE = dict(block_size=4, num_blocks=14, max_batch=4, prefill_chunk=8,
              max_model_len=64)


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


@pytest.fixture(scope="module")
def runs(models):
    return F.model_runs(ARCH, *models, prompt_len=13, chunk=16, bs=4,
                        table_width=6, ring=False)


@pytest.fixture(scope="module")
def served(models):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, n) for n in (14, 10, 18, 9, 12)]
    return F.engine_pair(ARCH, *models, ENGINE, prompts, [10, 12, 8, 9, 7],
                         late=2, late_after=5)


@pytest.mark.parametrize("shrink", [False, True])
def test_config_matches_jax(shrink):
    F.check_config(ARCH, shrink)


def test_params_from_numpy_round_trip(models):
    F.check_round_trip(ARCH, *models)
    _jp, tp = models
    dense, moe_layer = tp["layers"]
    # the leading dense layer is dense_d_ff wide; the MoE layer carries
    # its expert stacks, router and shared experts
    assert dense["ffn"]["up"]["w"].shape == (64, 128)
    assert moe_layer["ffn"]["up"].shape == (4, 64, 64)
    assert moe_layer["ffn"]["shared"]["up"]["w"].shape == (64, 64 * 2)
    assert set(dense["attn"]) == {"q", "kv_down", "k_up", "v_up", "o"}


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_prefill_and_decode_logits_match_jax(runs, precision):
    (lj, _), (lt, _) = runs[precision]["jax"], runs[precision]["torch"]
    assert lt.shape == lj.shape == (13 + 8, 128)
    np.testing.assert_allclose(lt, lj, **F.TOL)


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_greedy_continuation_matches_jax(runs, precision):
    assert runs[precision]["torch"][1] == runs[precision]["jax"][1]


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_full_sequence_forward_matches_jax(models, precision):
    F.check_logits_fn(ARCH, *models, precision)


def test_init_draws_every_layer_kind():
    """The port's own init (torch generator) builds the same layer
    layout as the converted JAX weights."""
    from repro_torch.models import transformer as M
    _jcfg, tcfg = F.cfgs(ARCH, "bnn")
    params = M.init(torch.Generator().manual_seed(0), tcfg)
    _jp, tp = F.models(ARCH)
    shapes = lambda p: {k: (shapes(v) if isinstance(v, dict)
                            else tuple(v.shape)) for k, v in p.items()}
    assert [shapes(p) for p in params["layers"]] == \
        [shapes(p) for p in tp["layers"]]


def test_engine_matches_jax_with_preemption(served):
    F.check_engine_tokens(served)
    (_je, _), (te, _) = served
    assert te.stats()["preemptions"] >= 1
    assert te.stats()["mixer"]["blocks"]["layout"] == "paged"
    # MLA pools hold the compressed latents
    pool = te.cache.pools[0]
    assert set(pool) == {"c_kv", "k_rope"}
    assert pool["c_kv"].shape == (14, 4, 32)


def test_engine_stats_match_jax(served):
    F.check_engine_stats(served)
