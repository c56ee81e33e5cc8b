"""The port's serve CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``): given the JAX CLI's own reduced
parameters and prompts, ``serve`` and ``serve_legacy`` return the JAX
CLI's token arrays — greedy and sampled, the paged engine and the
legacy loop, with stop tokens (ragged) — all equal exactly.  Every
option of a later slice raises and names its ROADMAP.md item; without a
card the launcher refuses to run unless asked for the CPU."""
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


def _both(jax_setup, **kw):
    _jp, tp, prompts = jax_setup
    want = jserve.serve(ARCH, **RUN, verbose=False, **kw)
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


@pytest.mark.parametrize("greedy", [True, False])
def test_serve_legacy_returns_jax_tokens(jax_setup, greedy):
    want, got = _both(jax_setup, engine="legacy", greedy=greedy)
    np.testing.assert_array_equal(got, np.asarray(want))
    if greedy:                      # the third leg: legacy = paged
        paged = S.serve(ARCH, **RUN, device="cpu", params=jax_setup[1],
                        prompts=jax_setup[2], verbose=False)
        np.testing.assert_array_equal(got, paged)


def test_stop_tokens_end_at_first_occurrence(jax_setup):
    """A stop token taken from a sampled request's own output, at the
    index of its first occurrence there: that request ends right after
    it (the output is then ragged), the others are unchanged."""
    _want, full = _both(jax_setup, **SAMPLED)
    plen = RUN["prompt_len"]
    gen = list(full[0, plen:])
    j = next(j for j in range(1, len(gen) - 1) if gen.index(gen[j]) == j)
    want, got = _both(jax_setup, **SAMPLED, stop=(gen[j],))
    assert isinstance(got, list) and len(got) == len(want)
    for g, w, f in zip(got, want, full):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert list(g) == list(f[:len(g)])
        out = list(f[plen:])
        stop_at = out.index(gen[j]) + 1 if gen[j] in out else len(out)
        assert len(g) == plen + stop_at
    assert len(got[0]) == plen + j + 1


def test_main_runs_on_the_cpu_when_asked(capsys):
    seqs = S.main(["--smoke", "--precision", "bnn", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "8", "--gen", "4",
                   "--temperature", "0.7", "--top-k", "20"])
    assert seqs.shape == (2, 12)
    out = capsys.readouterr().out
    assert "[serve] bnn-lm-100m precision=bnn batch=2 device=cpu" in out
    assert "prefix-cache on" in out


@pytest.mark.parametrize("name", sorted(S.LATER))
def test_later_options_raise_by_roadmap_item(name):
    default, item = S.LATER[name]
    flag = "--" + name.replace("_", "-")
    arg = [flag] if isinstance(default, bool) else \
        [flag, {int: "2", str: "x"}.get(type(default), "x")]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        S.main(["--smoke", "--device", "cpu", *arg])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_without_a_card_the_launcher_refuses():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.serve(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.setup(ARCH, smoke=True)
