"""Port family: the dense decoders of the config registry — llama3.2-3b
(tied head), codeqwen1.5-7b (QKV bias), gemma-7b (GeGLU, embeddings
scaled by sqrt(d_model), tied head) and qwen1.5-0.5b (QKV bias, tied
head) — and the front-end configs (musicgen-large, pixtral-12b), against
the JAX package: every config field by field; each dense one at reduced
width through chunked prefill and paged decode, logits and greedy
continuations at bnn and bf16.  The front-end configs are refused by
the model stack (tests/test_torch_family_swa.py).  Tolerances in
tests/_torch_family.py."""
import numpy as np
import pytest
import torch

import _torch_family as F

torch.set_num_threads(1)

DENSE = ("llama3.2-3b", "codeqwen1.5-7b", "gemma-7b", "qwen1.5-0.5b")
FRONT_END = ("musicgen-large", "pixtral-12b")


@pytest.mark.parametrize("shrink", [False, True])
@pytest.mark.parametrize("arch", DENSE + FRONT_END)
def test_config_matches_jax(arch, shrink):
    F.check_config(arch, shrink)


@pytest.mark.parametrize("arch", DENSE)
def test_logits_and_greedy_match_jax(arch):
    """The reduced config's weights from the JAX init, converted; a
    13-token prompt in chunks of 8 over blocks of 4, then 8 greedy
    decode steps, each side feeding back its own token."""
    jp, tp = F.models(arch)
    F.check_round_trip(arch, jp, tp)
    runs = F.model_runs(arch, jp, tp, prompt_len=13, chunk=8, bs=4,
                        table_width=6, ring=False)
    for precision in ("bnn", "bf16"):
        (lj, tok_j), (lt, tok_t) = runs[precision]["jax"], \
            runs[precision]["torch"]
        assert lt.shape == lj.shape == (13 + 8, 128)
        np.testing.assert_allclose(lt, lj, **F.TOL, err_msg=precision)
        assert tok_t == tok_j, precision
