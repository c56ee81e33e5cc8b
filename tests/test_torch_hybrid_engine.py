"""The port's serving engine on the reduced jamba hybrid against the JAX
engine (split from tests/test_torch_family_hybrid.py, whose fixtures and
helpers it shares): greedy tokens and stats with 2 slots under a batch
of 4 and a block pool small enough that admissions wait for a slot while
blocks are free and find a slot but too few blocks (the composites'
admission records equal).  The smoke's window:
tests/test_torch_hybrid_window.py.  Tolerances in
tests/_torch_family.py."""
import pytest
import torch

import _torch_family as F
from test_torch_family_hybrid import (ARCH, BS, ENGINE, MAX_NEW, S,  # noqa: F401
                                      _prompts, _watched_pair, models)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served(models):
    return _watched_pair(F.cfgs(ARCH, "bnn"), *models, ENGINE, _prompts(),
                         list(MAX_NEW))


def test_engine_matches_jax_with_both_shortages(served):
    (je, jrun), (te, trun), (jrec, trec) = served
    F.check_engine_tokens(((je, jrun), (te, trun)))
    # the composite made the same admission decisions, with the same
    # free slots and blocks around each, as the JAX composite
    assert trec["attempts"] == jrec["attempts"]
    slot_waits, released = S.shortages(te, trec)
    assert slot_waits and released
    for a in released:                    # the slot went back, pos 0
        assert a["free_after"] == a["free_before"] and a["pos"] == 0
    st = te.stats()
    assert st["max_concurrent_decode"] >= 2 and st["preemptions"] >= 1
    assert te.cache.ssm.allocator.num_used == 0
    te.cache.ssm.allocator.check()
    te.cache.attn.allocator.check()
    # the admission budget comes from the block pool
    assert te.scheduler.cfg.max_tokens_in_flight == 2 * 9 * BS


def test_engine_stats_match_jax(served):
    """Both mixer members (blocks and slots), the photonic section."""
    (je, jrun), (te, trun), _recs = served
    F.check_engine_stats(((je, jrun), (te, trun)))
    mixer = te.stats()["mixer"]
    assert set(mixer) == {"blocks", "slots"}
    assert mixer["blocks"]["layers"] == 1 and mixer["slots"]["layers"] == 7
    assert mixer["slots"]["peak_used_slots"] == 2
