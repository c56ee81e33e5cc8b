"""chip_smoke.py's [spec] phase at reduced width on the CPU (see
tests/test_torch_spec_phase.py): its traffic's prompt lookup, admission
and preemption depend only on lengths and content, so the gates it needs
on the card (verify steps and drafts in each run, accepted and partly
accepted drafts over the phase, tokens equal spec_k 0's, greedy and
sampled) hold here too."""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S                                      # noqa: E402

torch.set_num_threads(1)


def test_spec_phase_gates_hold_at_reduced_width():
    launches = S.phase_spec(torch.device("cpu"), "cpu", smoke=True)
    assert set(S.SERVING_KERNELS) <= set(launches)


