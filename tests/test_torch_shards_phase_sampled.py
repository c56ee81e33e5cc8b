"""chip_smoke.py's ``[shards]`` phase at reduced width on the CPU: PD
(roles 1:2) sampled with [serve]'s C sampling: tokens equal one
engine's (C's, served here), and every count equals the card's
prediction (tests/_torch_shards_phase.py), the same as the greedy
run's."""
import sys
from pathlib import Path

import pytest
import torch

import _torch_shards_phase as P

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S                                      # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctx():
    return S.shards_setup(torch.device("cpu"), smoke=True)


def test_pd_sampled(ctx):
    assert S.shards_pd_sampled(ctx) == P.PD
