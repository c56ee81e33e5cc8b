"""chip_smoke.py's ``[tenants]`` phase at reduced width on the CPU: the
priority policy, the streaming front-end with cancellation and the
scoring re-check (tests/test_torch_tenants_phase.py: slo and the trace).

The counts are the card's (PERF.md, PR 22's prediction): they depend
only on the traffic's lengths and content.  The scoring re-check holds
the engine's logprobs to a teacher-forced pass through the plain
versions; on the CPU both are the plain versions, so they agree exactly,
and a logprob moved by more than the tolerance fails the check."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S                                      # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctx():
    return S.tenants_setup(torch.device("cpu"), smoke=True)


@pytest.fixture(scope="module")
def streamed(ctx):
    return S.tenants_stream(ctx)


def test_priority_tokens_and_counts(ctx):
    st = S.tenants_priority(ctx)
    assert (st["steps"], st["preemptions"], st["swap"]["swap_outs"]) == \
        (324, 12, 7)


def test_stream_cancel_and_scoring_counts(ctx, streamed):
    launches, res = streamed
    assert set(launches) >= {"fused_bnn", "paged_attention"}
    assert res["steps"] == 272
    assert res["cancelled"] == (23, S.CANCEL_AFTER)
    assert [len(s["logprobs"]) for s in res["scored"]] == [511] * 4
    assert [len(p) for p in res["scores"]] == [512] * 4
    heads = {tuple(p[:384].tolist()) for p in res["scores"]}
    assert heads == {tuple(p[:384].tolist()) for p in ctx["prompts"]}


def test_scoring_check_holds_and_catches_a_moved_logprob(ctx, streamed):
    _launches, res = streamed
    assert S.tenants_scoring_check(ctx, res) <= S.MAX_SCORE_GAP
    moved = [dict(s) for s in res["scored"]]
    moved[1]["logprobs"] = list(moved[1]["logprobs"])
    moved[1]["logprobs"][200] += 10 * S.MAX_SCORE_GAP
    with pytest.raises(AssertionError, match="before any accepted flip"):
        S.tenants_scoring_check(ctx, {**res, "scored": moved})


def test_score_logprobs_matches_the_engine_formula():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 11)).astype(np.float32)
    prompt = rng.integers(0, 11, 6)
    lp = S.score_logprobs(logits, prompt)
    ref = torch.log_softmax(torch.from_numpy(logits).double(), -1)
    np.testing.assert_allclose(
        lp, ref[torch.arange(5), torch.from_numpy(prompt[1:])].numpy(),
        rtol=1e-12)
