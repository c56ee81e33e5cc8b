"""chip_smoke.py's ``[shards]`` phase at reduced width on the CPU: PD
(roles 1:2) through the asyncio front-end (each stream equals A's), and
the slot path: mamba2 under 1:1 with the defaults (tokens equal one
engine's, every handoff carrying a recurrent slot).  Every count equals
the card's prediction (tests/_torch_shards_phase.py)."""
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


def test_pd_through_the_front_end(ctx):
    assert S.shards_pd_stream(ctx) == P.PD


def test_mamba2_slot_handoffs(ctx):
    assert S.shards_mamba2(ctx) == P.MAMBA2
