"""The port's serve CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``): given the JAX CLI's own reduced
parameters and prompts, ``serve`` returns the JAX CLI's token arrays —
greedy and sampled, with and without the prefix cache and swap — all
equal exactly; each JAX run once a session.  Stop tokens:
tests/test_torch_serve_cli_stop.py; the legacy loop, ``main`` and the
refused options: tests/test_torch_serve_cli_legacy.py."""
import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.layers import common as JC
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as S

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"
RUN = dict(smoke=True, batch=3, prompt_len=12, gen=8, precision="bnn")
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, sampling_seed=3)


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX CLI's params and prompts, the params converted."""
    try:
        jcfg, jp, _mesh = jserve._setup(ARCH, True, False, "bnn", 0)
        prompts = np.asarray(jserve._prompts(jcfg, RUN["batch"],
                                             RUN["prompt_len"], 0))
    finally:
        JC.clear_sharding_context()
    tcfg = S._config(ARCH, True, "bnn")
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg), prompts


_JAX_RUNS: dict = {}


def _jax_serve(**kw):
    """The JAX CLI's tokens under ``kw``, run once a session for each."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = jserve.serve(ARCH, **RUN, verbose=False, **kw)
    return _JAX_RUNS[key]


def _both(jax_setup, **kw):
    _jp, tp, prompts = jax_setup
    want = _jax_serve(**kw)
    got = S.serve(ARCH, **RUN, device="cpu", params=tp, prompts=prompts,
                  verbose=False, **kw)
    return want, got


@pytest.mark.parametrize("kw", [dict(), SAMPLED,
                                dict(prefix_cache=False,
                                     preempt_policy="recompute")],
                         ids=["greedy", "sampled", "no-prefix-recompute"])
def test_serve_returns_jax_tokens(jax_setup, kw):
    want, got = _both(jax_setup, **kw)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_array_equal(got, np.asarray(want))
