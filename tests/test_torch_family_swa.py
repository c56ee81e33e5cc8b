"""Port family: reduced mixtral-8x7b (GQA + sliding window run as ring
caches + MoE) against the JAX package — config, parameter conversion,
chunked prefill + paged decode logits over a ring that wraps, greedy
continuations, the full-sequence forward, and the serving engine's
greedy tokens under mid-stream admission and recompute preemption with
its ring wrapping (``ring_reuses > 0`` on both engines).  Tolerances in
tests/_torch_family.py."""
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.serving.mixer_state import ring_block_count as jring_blocks
from repro_torch.serving.mixer_state import ring_block_count

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"
# ring of the model runs: window 32 + chunk 8 -> 10 blocks of 4 = 40
# slots; a 45-token prompt and 8 decode steps wrap it
BS, CHUNK = 4, 8
# 21 allocatable blocks: the first three prompts fit (8 + 7 + 6 blocks),
# their growth does not, so the scheduler preempts
ENGINE = dict(block_size=BS, num_blocks=22, max_batch=4, prefill_chunk=CHUNK,
              max_model_len=96)


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


@pytest.fixture(scope="module")
def runs(models):
    width = ring_block_count(32, BS, CHUNK)
    return F.model_runs(ARCH, *models, prompt_len=45, chunk=CHUNK, bs=BS,
                        table_width=width, ring=True)


@pytest.fixture(scope="module")
def served(models):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n) for n in (30, 26, 22, 40, 52)]
    return F.engine_pair(ARCH, *models, ENGINE, prompts, [14, 16, 18, 8, 10],
                         late=2, late_after=6)


@pytest.mark.parametrize("shrink", [False, True])
def test_config_matches_jax(shrink):
    F.check_config(ARCH, shrink)


def test_ring_block_count_matches_jax():
    for args in ((32, 4, 8), (4096, 16, 128), (4096, 16, 1), (7, 3, 5)):
        assert ring_block_count(*args) == jring_blocks(*args)
    assert ring_block_count(4096, 16, 128) == 264       # 4224 tokens
    assert ring_block_count(32, 4, 8) == 10


def test_params_from_numpy_round_trip(models):
    F.check_round_trip(ARCH, *models)


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_ring_prefill_and_decode_logits_match_jax(runs, precision):
    (lj, _), (lt, _) = runs[precision]["jax"], runs[precision]["torch"]
    assert lt.shape == lj.shape == (45 + 8, 128)
    np.testing.assert_allclose(lt, lj, **F.TOL)


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_ring_greedy_continuation_matches_jax(runs, precision):
    assert runs[precision]["torch"][1] == runs[precision]["jax"][1]


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_full_sequence_forward_matches_jax(models, precision):
    F.check_logits_fn(ARCH, *models, precision, t=40)


def test_engine_matches_jax_with_ring_wrap_and_preemption(served):
    F.check_engine_tokens(served)
    (je, _), (te, _) = served
    for eng in (je, te):
        blk = eng.stats()["mixer"]["blocks"]
        assert blk["layout"] == "ring" and blk["ring_reuses"] > 0
        assert blk["ring_blocks"] == 10
    assert te.stats()["preemptions"] >= 1
    assert any(e["event"] == "evict" for e in te.scheduler.trace)
    # the ring table is exactly the ring wide, never padded
    assert te.cache.table_rows([], 2).shape == (2, 10)


def test_engine_stats_match_jax(served):
    F.check_engine_stats(served)


def _hybrid_cfg(case):
    """The reduced jamba hybrid, the reduced mamba2 with one attention
    layer in every period of 2 (both mix slot and block layouts), or a
    reduced front-end config."""
    import dataclasses

    from repro import configs as jconfigs
    from repro.configs.base import reduced as jreduced
    from repro_torch.configs.base import ArchConfig
    if case == "jamba":
        j = jreduced(jconfigs.get_config("jamba-1.5-large-398b"))
    elif case == "mamba2_attn_period":
        j = jreduced(jconfigs.get_config("mamba2-1.3b")).replace(
            attn_kind="gqa", attn_period=2, n_heads=4, n_kv_heads=4,
            head_dim=16)
    else:
        j = jreduced(jconfigs.get_config(case))
    return ArchConfig(**dataclasses.asdict(j))


@pytest.mark.parametrize("case", ["jamba", "mamba2_attn_period",
                                  "musicgen-large", "pixtral-12b"])
def test_ssm_and_hybrid_stacks_are_refused_by_name(case):
    """Stacks that mix SSM and attention layers (the jamba hybrid) are
    admitted by the model stack, and the mixer-state cache builds both
    members, the slots for the SSM layers and the blocks for the
    attention layers; under the prefix cache the slot member runs a
    snapshot index beside the block member's prefix index, without it
    neither.  The modality front-ends' backbones are admitted too
    (their stub front-ends are ported)."""
    from repro_torch.models import transformer as M
    from repro_torch.serving.block_cache import MixerStateCache
    cfg = _hybrid_cfg(case)
    if cfg.frontend != "none":
        M.check_supported(cfg)
        assert {mix for mix, _f in M.layer_plan(cfg)} == {"gqa"}
        return
    plan = M.layer_plan(cfg)
    assert {mix for mix, _f in plan} == {"ssm", "gqa"}
    M.check_supported(cfg)
    kw = dict(num_blocks=9, block_size=4, max_model_len=32, num_slots=3)
    on = MixerStateCache(cfg, **kw, snapshot_slots=5)
    assert on.prefix is not None and on.ssm.snapshots is not None
    assert on.ssm.snapshots.capacity == 5
    assert len(on.ssm.snapshots.pools) == len(on.ssm.layer_ids)
    assert on.prefix_section()["enabled"]
    cache = MixerStateCache(cfg, **kw, prefix_cache=False)
    assert cache.prefix is None and cache.ssm.snapshots is None
    assert not cache.prefix_section()["enabled"]
    assert cache.attn.layer_ids == [i for i, (m, _f) in enumerate(plan)
                                    if m == "gqa"]
    assert cache.ssm.layer_ids == [i for i, (m, _f) in enumerate(plan)
                                   if m == "ssm"]
    pools = cache.pools
    assert len(pools) == len(plan)
    for (mix, _f), pool in zip(plan, pools):
        assert set(pool) == ({"h", "conv"} if mix == "ssm" else {"k", "v"})
    assert set(cache.mixer_section()) == {"blocks", "slots"}
