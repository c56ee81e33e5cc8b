"""Sampled decoding through the engines, the port's against the JAX
package's (split from tests/test_torch_sampling.py): on the reduced
bnn-lm-100m, sampled tokens equal the JAX engine's, and a stop token
ends a sampled request at its first occurrence.  The Poisson trace
under the prefix cache and swap: tests/test_torch_sampling_trace.py."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.models import transformer as JM
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.interop import params_from_numpy
from repro_torch.serving import Engine, EngineConfig, SamplingParams

torch.set_num_threads(1)


# ------------------------------------------------------ through the engine

ENGINE = dict(block_size=4, num_blocks=33, max_batch=4, prefill_chunk=4,
              max_model_len=32)


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jconfigs.get_config("bnn-lm-100m")).replace(
        precision="bnn")
    tcfg = treduced(tconfigs.get_config("bnn-lm-100m")).replace(
        precision="bnn")
    jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             tcfg)


def _sampled(i):
    return SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                          seed=1000 + i)


@pytest.fixture(scope="module")
def sampled_run(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, n) for n in (5, 9, 3, 7)]
    je = JEngine(jp, jcfg, JEngineConfig(**ENGINE, attn_impl="xla",
                                         bnn_impl="xla"))
    te = Engine(tp, tcfg, EngineConfig(**ENGINE), device="cpu")
    outs = []
    for eng in (je, te):
        rids = [eng.submit(p, 12, sampling=_sampled(i))
                for i, p in enumerate(prompts)]
        out = eng.run()
        outs.append([out[r] for r in rids])
    return prompts, outs


def test_engine_sampled_tokens_match_jax(sampled_run):
    _prompts, (jout, tout) = sampled_run
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b, a)


def test_sampled_stop_token_takes_the_first_occurrence(models, sampled_run):
    """The stop token is one whose FIRST occurrence in a request's
    sampled output is at index j > 0: the request ends with exactly
    j + 1 tokens, equal to that output's head, and frees its blocks."""
    prompts, (_jout, tout) = sampled_run
    _jcfg, _jp, tcfg, tp = models
    gen = list(tout[1][len(prompts[1]):])
    firsts = [j for j in range(1, len(gen) - 1) if gen.index(gen[j]) == j]
    assert firsts, f"no token first occurs past index 0 in {gen}"
    j = firsts[len(firsts) // 2]
    eng = Engine(tp, tcfg, EngineConfig(**ENGINE), device="cpu")
    sp = _sampled(1)
    r = eng.submit(prompts[1], len(gen), sampling=SamplingParams(
        temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p,
        seed=sp.seed, stop=(gen[j],)))
    out = eng.run()
    assert list(out[r][len(prompts[1]):]) == gen[:j + 1]
    assert eng.requests[r].blocks == []
