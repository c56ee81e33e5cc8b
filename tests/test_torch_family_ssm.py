"""Port family: reduced mamba2-1.3b (the Mamba-2 SSD mixer over recurrent
slots, no FFN) against the JAX package — config, parameter conversion,
chunked prefill + paged decode logits and greedy continuations in a
recurrent slot, the full-sequence forward, and the serving engine's
greedy tokens with fewer slots than ``max_batch + 1``: admissions wait
for a slot, late arrivals join mid-stream, and released slots are
handed out again (zeroed).  Tolerances in tests/_torch_family.py."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_family as F
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving import mixer_state

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
S = importlib.util.module_from_spec(_spec)      # for its slot_owners
_spec.loader.exec_module(S)

ARCH = "mamba2-1.3b"
BS, CHUNK = 4, 8
# 2 allocatable slots under a batch of 4: the slots, not the batch, bound
# admission, and 6 requests reuse them
ENGINE = dict(block_size=BS, num_blocks=9, max_batch=4, num_slots=3,
              prefill_chunk=CHUNK, max_model_len=64)
PROMPTS = (19, 5, 12, 27, 3, 9)
MAX_NEW = (6, 9, 5, 4, 8, 7)


@pytest.fixture(scope="module")
def models():
    return F.models(ARCH)


@pytest.fixture(scope="module")
def runs(models):
    return F.model_runs(ARCH, *models, prompt_len=21, chunk=CHUNK, bs=BS,
                        table_width=1, ring=False, slot=2)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, n) for n in PROMPTS]


@pytest.fixture(scope="module")
def served(models):
    return F.engine_pair(ARCH, *models, ENGINE, _prompts(), list(MAX_NEW),
                         late=2, late_after=3)


@pytest.mark.parametrize("shrink", [False, True])
def test_config_matches_jax(shrink):
    F.check_config(ARCH, shrink)


def test_params_from_numpy_round_trip(models):
    F.check_round_trip(ARCH, *models)
    _jp, tp = models
    assert set(tp["layers"][0]["attn"]) == {
        "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
        "out_proj"}


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_slot_prefill_and_decode_logits_match_jax(runs, precision):
    (lj, _), (lt, _) = runs[precision]["jax"], runs[precision]["torch"]
    assert lt.shape == lj.shape == (21 + 8, 128)
    np.testing.assert_allclose(lt, lj, **F.TOL)


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_slot_greedy_continuation_matches_jax(runs, precision):
    assert runs[precision]["torch"][1] == runs[precision]["jax"][1]


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_full_sequence_forward_matches_jax(models, precision):
    """Three SSD chunks of 8 (the last padded)."""
    F.check_logits_fn(ARCH, *models, precision, t=20)


def test_engine_matches_jax_with_slot_reuse(served):
    F.check_engine_tokens(served)
    (je, _), (te, _) = served
    for eng in (je, te):
        slots = eng.stats()["mixer"]["slots"]
        assert slots["layout"] == "slot" and slots["num_slots"] == 2
        assert slots["peak_used_slots"] == 2 and slots["used_slots"] == 0
    # the slots bounded admission: requests waited with batch rows free
    waits = [e for e in te.scheduler.trace
             if e["event"] == "defer" and e["reason"] == "no_blocks"]
    assert waits
    owners = S.slot_owners(te)
    assert sorted(owners) == [1, 2]
    assert sum(len(r) for r in owners.values()) == len(PROMPTS)
    assert te.stats()["preemptions"] == 0
    # no block pool: the table is one scratch column, the budget open
    assert te.cache.attn is None
    assert te.cache.table_rows([], 3).shape == (3, 1)
    assert te.scheduler.cfg.max_tokens_in_flight == 1 << 30


def test_engine_stats_match_jax(served):
    F.check_engine_stats(served)


def test_reused_slots_must_be_zeroed(models, monkeypatch):
    """A slot handed out again without zeroing keeps its last owner's
    state, and the engine's tokens then leave the JAX engine's: the
    parity above sees the zeroing."""
    (_je, (jrids, jout)), _ = F.engine_pair(
        ARCH, *models, ENGINE, _prompts(), list(MAX_NEW), late=2,
        late_after=3)

    def alloc_without_zeroing(self, req):
        if req.slot is not None:
            return True
        got = self.allocator.alloc(1)
        if got is None:
            return False
        req.slot = got[0]
        self.peak_used = max(self.peak_used, self.allocator.num_used)
        return True

    monkeypatch.setattr(mixer_state.RecurrentSlotState, "_alloc_slot",
                        alloc_without_zeroing)
    _jcfg, tcfg = F.cfgs(ARCH, "bnn")
    te = Engine(models[1], tcfg, EngineConfig(**ENGINE), device="cpu")
    _rids, tout = F.drive(te, _prompts(), list(MAX_NEW), 2, 3)
    first = {rids[0] for rids in S.slot_owners(te).values()}
    for rid in first:                     # fresh slots: zeros either way
        np.testing.assert_array_equal(tout[rid], jout[rid])
    assert any(not np.array_equal(tout[rid], jout[rid])
               for rid in jrids if rid not in first)


def test_engine_without_a_card_raises(models):
    _jcfg, tcfg = F.cfgs(ARCH, "bnn")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(models[1], tcfg, EngineConfig(**ENGINE))
