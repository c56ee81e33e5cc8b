"""The port's serve CLI with stop tokens (tests/test_torch_serve_cli.py):
with the JAX CLI's own reduced parameters and prompts, a stop token
taken from a sampled request's own output ends that request at its
first occurrence, the output ragged, equal to the JAX CLI's exactly."""
import numpy as np
import torch

from test_torch_serve_cli import RUN, SAMPLED, _both, jax_setup  # noqa: F401

torch.set_num_threads(1)


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


