"""chip_smoke.py's ``[serve]`` phase at reduced width on the CPU.

Admission, prefix matching, copy-on-write and preemption depend only on
the prompts' lengths and content, so the phase's traffic at the reduced
config's vocabulary (same lengths, same sharing) makes on the CPU the
prefix hits, copies and swaps its gates need on the card; the phase's
token gates (A = B, C = D, C' stops at the first stop token, the legacy
loop = the paged serve) and the swap round trip's bit-equality hold
here too."""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S                                      # noqa: E402
from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.configs.base import reduced                # noqa: E402

torch.set_num_threads(1)


def test_serve_traffic_shares_heads_and_repeats_whole_prompts():
    full = S.serve_traffic(get_config("bnn-lm-100m").vocab)
    small = S.serve_traffic(reduced(get_config("bnn-lm-100m")).vocab)
    assert [len(p) for p in small] == [len(p) for p in full]
    assert len(full) == 24
    assert all(len(p) % 16 == 0 and 416 <= len(p) <= 640 for p in full)
    heads = {p[:384].tobytes() for p in full}
    assert len(heads) == 4
    for at, src in ((12, 8), (17, 13), (22, 18)):
        np.testing.assert_array_equal(full[at], full[src])
    engine = S.SERVE_ENGINE
    assert engine["num_blocks"] - 1 == 193 and engine["block_size"] == 16
    assert S.SERVE_CALM["prefix_cache"] is False


def test_serve_phase_gates_hold_at_reduced_width():
    launches, out_a = S.phase_serve(torch.device("cpu"), "cpu", smoke=True)
    assert set(S.SERVING_KERNELS) <= set(launches)
    assert len(out_a) == 24
