"""The stub front-ends of the legacy loop against the JAX package
(moved from tests/test_torch_legacy.py for time): the three-leg family
gate (tests/test_torch_legacy_gate.py) on musicgen and pixtral, and
``logits_fn`` over their embeddings (musicgen's audio frames, pixtral's
patch prefix before the tokens) within TOL of JAX (float32 on both
sides, as tests/test_torch_model.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.models import transformer as JM
from repro_torch.models import transformer as M
from test_torch_legacy_gate import check_three_leg

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("musicgen-large", "pixtral-12b")


@pytest.fixture(scope="module")
def models():
    return {arch: F.models(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_three_leg_gate(models, arch):
    check_three_leg(models, arch)


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
@pytest.mark.parametrize("arch", ["musicgen-large", "pixtral-12b"])
def test_frontend_logits_match_jax(models, arch, precision):
    """musicgen: audio frame embeddings alone; pixtral: the patch
    prefix, then tokens; and each backbone over tokens alone."""
    jcfg, tcfg = F.cfgs(arch, precision)
    jp, tp = models[arch]
    rng = np.random.default_rng(7)
    b, t = 2, 11
    emb = (rng.standard_normal((b, t, jcfg.d_model)) * 0.5).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (b, t))
    if arch == "musicgen-large":
        jbatch, kw = {"embeds": emb}, dict(embeds=torch.from_numpy(emb))
    else:
        pre = emb[:, :jcfg.frontend_prefix]
        jbatch = {"prefix_embeds": pre, "tokens": toks}
        kw = dict(prefix_embeds=torch.from_numpy(pre),
                  tokens=torch.from_numpy(toks))
    want = np.asarray(JM.logits_fn(jp, jcfg, {k: jnp.asarray(v)
                                              for k, v in jbatch.items()}))
    got = F.np_(M.logits_fn(tp, tcfg, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    want = np.asarray(JM.logits_fn(jp, jcfg, {"tokens": jnp.asarray(toks)}))
    got = F.np_(M.logits_fn(tp, tcfg, torch.from_numpy(toks)))
    np.testing.assert_allclose(got, want, **TOL)
