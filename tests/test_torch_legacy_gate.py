"""The three-leg family gate of the legacy decode loop (moved from
tests/test_torch_legacy.py for time): the port's paged engine = the JAX
engine = the port's legacy loop (= the JAX legacy loop) in greedy
tokens, both engines at their defaults (prefix cache on, swap), the
same weights (JAX's, carried across).  bnn-lm-100m and deepseek-v2-lite
here; mixtral in tests/test_torch_legacy_gate_ring.py, musicgen and
pixtral in tests/test_torch_legacy_stubs.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.models import transformer as JM
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch.launch import serve as S
from repro_torch.serving import Engine, EngineConfig

torch.set_num_threads(1)

ARCHS = ("bnn-lm-100m", "deepseek-v2-lite-16b")


@pytest.fixture(scope="module")
def models():
    return {arch: F.models(arch) for arch in ARCHS}


def _jax_legacy(jcfg, jp, prompts, gen):
    """The JAX package's legacy greedy loop (serve_legacy without the
    mesh)."""
    b, plen = prompts.shape
    max_len = plen + gen
    caches = JM.init_cache(jcfg, b, max_len)
    dec = jax.jit(lambda p, c, tok, ln: JM.decode_step(p, jcfg, tok, c, ln))
    tok = jnp.asarray(prompts[:, :1])
    out = [tok]
    for i in range(max_len - 1):
        logits, caches = dec(jp, caches, tok, jnp.int32(i))
        tok = (jnp.asarray(prompts[:, i + 1:i + 2]) if i + 1 < plen
               else jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32))
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1)


def check_three_leg(models, arch):
    """Paged engine (port) = JAX engine = legacy loop (port and JAX), at
    both engines' defaults; mixtral's prompts outgrow its 32-token
    window, so the ring wraps."""
    jcfg, tcfg = F.cfgs(arch, "bnn")
    jp, tp = models[arch]
    plen, gen = (30, 10) if arch == "mixtral-8x7b" else (7, 6)
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab, (2, plen)).astype(np.int32)
    kw = dict(block_size=4, num_blocks=33, max_batch=2, prefill_chunk=4,
              max_model_len=plen + gen)
    je = JEngine(jp, jcfg, JEngineConfig(**kw, attn_impl="xla",
                                         bnn_impl="xla"))
    te = Engine(tp, tcfg, EngineConfig(**kw), device="cpu")
    engine_out = []
    for eng in (je, te):
        rids = [eng.submit(p, gen) for p in prompts]
        out = eng.run()
        engine_out.append(np.stack([out[r] for r in rids]))
    legacy, _tps = S.run_legacy(tp, tcfg, prompts, gen, device="cpu")
    np.testing.assert_array_equal(engine_out[1], engine_out[0])
    np.testing.assert_array_equal(legacy, engine_out[1])
    np.testing.assert_array_equal(legacy, _jax_legacy(jcfg, jp, prompts, gen))
    if arch == "mixtral-8x7b":
        assert te.stats()["mixer"]["blocks"]["ring_reuses"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_three_leg_gate(models, arch):
    check_three_leg(models, arch)
