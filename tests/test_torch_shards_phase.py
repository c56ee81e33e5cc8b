"""chip_smoke.py's ``[shards]`` phase at reduced width on the CPU: S2
(two mixed shards, a migration mid-decode) and S2 kill (shard 1 reaped
at an explicit clock); the PD runs and the slot path:
tests/test_torch_shards_phase_pd.py and _phase_stream.py.

The phase's own gates run as on the card (tokens equal A's, every
request finishes, both shards decode, one migration; the reaped shard's
requests rescued on shard 0), and every count equals the prediction
the card must reproduce (tests/_torch_shards_phase.py)."""
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


def test_s2_mixed_with_a_migration(ctx):
    assert S.shards_mixed(ctx) == P.S2


def test_s2_kill_by_reap(ctx):
    assert S.shards_kill(ctx) == P.KILL


def test_after_step_fires_once_at_its_step():
    class Fake:
        def __init__(self):
            self.n = 0

        def step(self):
            self.n += 1
            return True
    seen = []
    fake = Fake()
    S.after_step(3, lambda se: seen.append(se.n))(fake)
    for _ in range(6):
        fake.step()
    assert seen == [3]
