"""Sampled decoding through the engines on the Poisson trace of
tests/test_torch_prefix_swap.py under the prefix cache and swap (reduced
bnn-lm-100m, mixtral, deepseek; split from tests/test_torch_sampling.py):
the port's sampled tokens equal the JAX engine's, and equal the same
trace served without either (a token is a function of its seed and
position).  deepseek-v2-lite's trace: tests/test_torch_sampling_trace_mla.py."""
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch.serving import Engine, EngineConfig
from test_torch_sampling_engine import _sampled

torch.set_num_threads(1)


def served_trace(arch):
    """The JAX engine, the port's, and the port's without the prefix
    cache and swap on ``arch``'s Poisson trace, sampled."""
    kw, shared, tails, gen = F.PREFIX_FAMILIES[arch]
    jp, tp = F.models(arch)
    jcfg, tcfg = F.cfgs(arch, "bnn")
    arrival, prompts = F.poisson_trace(jcfg.vocab, shared, tails)
    engines = [
        JEngine(jp, jcfg, JEngineConfig(**kw, attn_impl="xla",
                                        bnn_impl="xla")),
        Engine(tp, tcfg, EngineConfig(**kw), device="cpu"),
        Engine(tp, tcfg, EngineConfig(**{**kw, "num_blocks": 65},
                                      prefix_cache=False,
                                      preempt_policy="recompute"),
               device="cpu")]
    return [(e, F.drive_trace(e, arrival, prompts, gen, _sampled))
            for e in engines]


# deepseek's: tests/test_torch_sampling_trace_mla.py
@pytest.fixture(scope="module", params=["bnn-lm-100m", "mixtral-8x7b"])
def sampled_trace(request):
    return served_trace(request.param)


def test_sampled_trace_matches_jax_under_prefix_cache_and_swap(sampled_trace):
    (_je, jout), (te, tout), (calm, cout) = sampled_trace
    for a, b, c in zip(jout, tout, cout):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, b)
    st = te.stats()
    assert st["prefix_cache"]["hits"] > 0 and st["swap"]["swap_outs"] > 0
    assert calm.stats()["preemptions"] == 0
