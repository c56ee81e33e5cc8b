"""The port's legacy decode loop and abstract init against the JAX
package, on the reduced configs and JAX's weights.

* ``init_cache`` gives JAX's per-layer cache shapes; ``decode_step``
  (one scalar position for the whole batch, a dense cache: GQA, the
  sliding-window ring wrapping, MLA's decompressing form, the SSD
  recurrence) gives JAX's logits at every step within TOL.
* The three-leg family gate (paged engine = JAX engine = legacy loop):
  tests/test_torch_legacy_gate.py (bnn-lm-100m, deepseek-v2-lite),
  tests/test_torch_legacy_gate_ring.py (mixtral) and
  tests/test_torch_legacy_stubs.py (musicgen, pixtral, with the stub
  front-ends' ``logits_fn``), moved there for time.
* ``abstract_init`` gives JAX's parameter shapes on the ``meta``
  device, allocating nothing.

TOL: float32 on both sides, as tests/test_torch_model.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.models import transformer as JM
from repro_torch.models import transformer as M

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_ARCHS = ("bnn-lm-100m", "mixtral-8x7b", "deepseek-v2-lite-16b",
               "mamba2-1.3b")


@pytest.fixture(scope="module")
def models():
    return {arch: F.models(arch) for arch in MODEL_ARCHS}


def _layer_caches(jcfg, caches):
    """JAX's segment-structured caches as one dict per layer, in the
    walk of ``_iter_layers``."""
    out = []
    for (kind, plan, n), seg in zip(JM.segments(jcfg), caches):
        if kind == "unroll":
            out.extend(seg)
        else:
            for gi in range(n):
                out.extend({k: v[gi] for k, v in seg[f"l{li}"].items()}
                           for li in range(len(plan)))
    return out


@pytest.mark.parametrize("arch", ["bnn-lm-100m", "mixtral-8x7b",
                                  "deepseek-v2-lite-16b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b"])
def test_init_cache_shapes_equal_jax(arch):
    jcfg, tcfg = F.cfgs(arch, "bnn")
    want = _layer_caches(jcfg, JM.init_cache(jcfg, 3, 40))
    got = M.init_cache(tcfg, 3, 40)
    assert len(got) == len(want) == tcfg.n_layers
    for g, w in zip(got, want):
        assert {k: tuple(v.shape) for k, v in g.items()} == \
            {k: tuple(v.shape) for k, v in w.items()}
        assert all(float(v.abs().sum()) == 0 for v in g.values())


CASES = {
    # case: (arch, config change, prompt, decoded tokens)
    "gqa": ("bnn-lm-100m", {}, 9, 8),
    "gqa-window-wraps": ("bnn-lm-100m", dict(sliding_window=5), 9, 8),
    "mixtral-ring": ("mixtral-8x7b", {}, 30, 10),
    "mla": ("deepseek-v2-lite-16b", {}, 9, 8),
    "ssd": ("mamba2-1.3b", {}, 9, 8),
}


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_step_logits_match_jax(models, case, precision):
    arch, change, plen, gen = CASES[case]
    jcfg, tcfg = F.cfgs(arch, precision)
    jcfg, tcfg = jcfg.replace(**change), tcfg.replace(**change)
    jp, tp = models[arch]
    b, max_len = 2, plen + gen
    seq = np.random.default_rng(5).integers(0, jcfg.vocab, (b, max_len))
    jdec = jax.jit(lambda p, c, tok, ln: JM.decode_step(p, jcfg, tok, c, ln))
    jc = JM.init_cache(jcfg, b, max_len)
    tc = M.init_cache(tcfg, b, max_len)
    for i in range(max_len - 1):
        want, jc = jdec(jp, jc, jnp.asarray(seq[:, i:i + 1], jnp.int32),
                        jnp.int32(i))
        got, tc = M.decode_step(tp, tcfg, torch.from_numpy(seq[:, i:i + 1]),
                                tc, i)
        np.testing.assert_allclose(F.np_(got), np.asarray(want), **TOL,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ["bnn-lm-100m", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b", "pixtral-12b"])
def test_abstract_init_shapes_equal_jax_and_allocate_nothing(arch):
    jcfg, tcfg = F.cfgs(arch, "bnn")
    shapes, _specs = JM.abstract_init(jcfg)
    abstract = M.abstract_init(tcfg)
    want = []
    for (kind, plan, n), seg in zip(JM.segments(jcfg), shapes["segments"]):
        if kind == "unroll":
            want += [jax.tree.map(lambda a: tuple(a.shape), p) for p in seg]
            continue
        for _gi in range(n):        # a stacked period: drop the scan axis
            want += [jax.tree.map(lambda a: tuple(a.shape[1:]),
                                  seg[f"l{li}"]) for li in range(len(plan))]
    got = [jax.tree.map(lambda v: tuple(v.shape), p)
           for p in abstract["layers"]]
    assert got == want
    assert tuple(abstract["embed"]["w"].shape) == \
        tuple(shapes["embed"]["w"].shape)
    for v in jax.tree_util.tree_leaves(abstract):
        assert v.device.type == "meta" and v.dtype == torch.float32
