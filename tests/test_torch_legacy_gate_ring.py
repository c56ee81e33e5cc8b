"""The three-leg family gate (tests/test_torch_legacy_gate.py) on the
reduced mixtral: its prompts outgrow the 32-token window, so the paged
engine's ring wraps while the legacy loop keeps a dense cache."""
import pytest
import torch

import _torch_family as F
from test_torch_legacy_gate import check_three_leg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return {"mixtral-8x7b": F.models("mixtral-8x7b")}


@pytest.mark.parametrize("arch", ["mixtral-8x7b"])
def test_three_leg_gate(models, arch):
    check_three_leg(models, arch)
