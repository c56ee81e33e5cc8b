"""Sampled decoding through the engines on deepseek-v2-lite's Poisson
trace under the prefix cache and swap (tests/test_torch_sampling_trace.py
has bnn-lm-100m's and mixtral's): the port's sampled tokens equal the JAX
engine's and the same trace's without either."""
import pytest
import torch

from test_torch_sampling_trace import (  # noqa: F401
    served_trace, test_sampled_trace_matches_jax_under_prefix_cache_and_swap)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["deepseek-v2-lite-16b"])
def sampled_trace(request):
    return served_trace(request.param)
