"""chip_smoke.py's ``[shards]`` phase at reduced width on the CPU: PD
(roles 1:2) greedy and traced (sampled, and through the front-end:
tests/test_torch_shards_phase_sampled.py, _phase_stream.py).  The
phase's gates run as on the card (tokens equal A's; each request handed
off once; the decode shards prefill nothing; the bytes they adopt sum
to handoff_bytes; three valid traces, one merged handoff flow each, the
replays' handoffs_in summing to the handoffs) and every count equals
the card's prediction (tests/_torch_shards_phase.py), handoff bytes and
transfer steps at the full width's sizes.  The full-width byte count
itself is checked by hand for bnn-lm-100m's blocks."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_shards_phase as P

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S                                      # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctx():
    return S.shards_setup(torch.device("cpu"), smoke=True)


def test_pd_greedy_traced(ctx):
    assert S.shards_pd(ctx) == P.PD


def test_full_width_bytes_count_full_width_host_copies():
    """``full_width_bytes`` counts what host_bytes would at full width:
    a request with 3 copied blocks of bnn-lm-100m (12 layers of K and V,
    12 heads of 64, blocks of 16, float32) and 2 tokens out."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Request
    cfg = get_config("bnn-lm-100m").replace(precision="bnn")
    count = S.full_width_bytes(cfg, 16)
    req = Request(0, np.zeros(40, np.int32), 8)
    req.out = [1, 2]
    req.host_kv = [{"k": torch.zeros(3, 16, 4, 4)}]   # 3 blocks, any width
    block = 12 * 2 * 16 * 12 * 64 * 4
    assert count(req) == 40 * 4 + 2 * 4 + 3 * block
