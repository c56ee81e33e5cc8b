"""chip_smoke.py's ``[tenants]`` phase at reduced width on the CPU: the
slo policy and the trace file (tests/test_torch_tenants_phase_stream.py:
the priority policy, the front-end and scoring).

Admission, preemption and the tenant budget's defers depend only on the
prompts' lengths and content, and tokens do not depend on the schedule,
so the phase's traffic at the reduced config's vocabulary (the same
lengths and sharing) makes here exactly the counts the card must show:
the prediction PERF.md records for the phase.  The phase's own gates
(tokens equal A's, chat within its budget, the victims, the trace's sums
and tracks) run as on the card."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S                                      # noqa: E402

torch.set_num_threads(1)

# the counts of the phase's slo run (PERF.md, PR 22's prediction)
SLO = dict(steps=274, preemptions=15, swap_outs=11, swap_ins=7,
           defers={"tenant_budget": 1116, "no_blocks": 163, "no_slot": 46})


@pytest.fixture(scope="module")
def ctx():
    return S.tenants_setup(torch.device("cpu"), smoke=True)


def test_slo_tokens_budget_and_trace_counts(ctx):
    untraced = S.tenants_slo(ctx)
    got = S.tenants_trace(ctx, untraced)
    for key, want in SLO.items():
        assert got[key] == want, key
    assert untraced["steps"] == SLO["steps"]
    assert untraced["preemptions"] == SLO["preemptions"]
    # every victim was a batch request, and batch ran each time
    assert len(got["victims"]) == SLO["swap_outs"]
    assert all(t == "batch" and batch for _r, t, batch in got["victims"])


def test_slo_victims_gate_catches_a_chat_victim():
    records = [{"type": "request", "event": "submit", "rid": 0,
                "tenant": "chat"},
               {"type": "request", "event": "submit", "rid": 1,
                "tenant": "batch"},
               {"type": "request", "event": "admit", "rid": 0},
               {"type": "request", "event": "admit", "rid": 1},
               {"type": "request", "event": "swap_out", "rid": 0,
                "step": 3}]
    with pytest.raises(AssertionError, match="chat request 0"):
        S.slo_victims(records)
    records[-1]["rid"] = 1
    assert S.slo_victims(records) == ([(1, "batch", True)], {})
