"""The port's serve CLI, continued (tests/test_torch_serve_cli.py): with
the JAX CLI's own reduced parameters and prompts, ``serve_legacy``
returns the JAX legacy loop's tokens (greedy and sampled) and equals the
paged serve; ``main`` runs on the CPU when asked; every option of a
later slice raises and names its ROADMAP.md item; without a card the
launcher refuses to run unless asked for the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.launch import serve as S
from test_torch_serve_cli import ARCH, RUN, _both, jax_setup  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("greedy", [True, False])
def test_serve_legacy_returns_jax_tokens(jax_setup, greedy):
    want, got = _both(jax_setup, engine="legacy", greedy=greedy)
    np.testing.assert_array_equal(got, np.asarray(want))
    if greedy:                      # the third leg: legacy = paged
        paged = S.serve(ARCH, **RUN, device="cpu", params=jax_setup[1],
                        prompts=jax_setup[2], verbose=False)
        np.testing.assert_array_equal(got, paged)


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
