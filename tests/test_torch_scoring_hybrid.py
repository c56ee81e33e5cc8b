"""tests/test_torch_scoring.py's scoring checks on the reduced jamba
hybrid: its composite cache (recurrent slots with snapshots beside the
paged attention blocks) admits a scoring request through its scoring
branch, a fresh slot and no adopted block, in both packages alike."""
import pytest
import torch

from test_torch_scoring import (serve_both,  # noqa: F401
                                test_scoring_engine_equals_jax,
                                test_scoring_logprobs_match_jax)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scored():
    return serve_both("jamba-1.5-large-398b")
