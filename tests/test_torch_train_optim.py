"""The port's optimizer and gradient compression against the JAX package,
fed the same gradients: JAX's own gradients of the reduced bnn-lm-100m
at ``bnn_train``, carried into the port's trainable tree.

AdamW (``optim/optimizer.update``) over four steps, float32 and bf16
moments, the clip active and not, through the warm-up and the cosine,
each step started from JAX's params and state before it: params and
float32 moments within 1e-6 of each leaf's largest element of JAX's,
bf16 moments within one bf16 rounding step (BF16_STEP); the schedule and
the global norm; the tied head stays a view of the updated embedding.
The int8 error-feedback round trip bit-equal over two steps, and
``wire_bytes`` equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import assert_leaves_close, batch_np, cfgs, np_, to_port
from repro.models import transformer as JM
from repro.optim import compress as jcompress, optimizer as jopt
from repro_torch import tree as T
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as M
from repro_torch.optim import compress, optimizer as opt

torch.set_num_threads(1)

REL = 1e-6          # |port - JAX| <= REL x the leaf's largest |element|
# bf16 moments: XLA contracts b1 * m + (1 - b1) * g into one fused
# multiply-add (one rounding) where torch rounds twice, so the float32
# moment may differ by an ulp, and where that straddles a bf16 rounding
# boundary the stored moment differs by one bf16 step (at most 2**-7
# of the value: 8 significant bits)
BF16_STEP = 2.0 ** -7
STEPS = 4


@pytest.fixture(scope="module")
def model():
    """(jcfg, tcfg, JAX params, JAX gradients at two batches)."""
    jcfg, tcfg = cfgs("bnn-lm-100m", "bnn_train")
    params, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    vg = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, jcfg, b,
                                                  loss_chunk=16)[0]))
    grads = [vg(params, batch_np(jcfg.vocab, 2, 16, s)) for s in (0, 1)]
    return jcfg, tcfg, params, grads


def _port_state(js, tcfg, dtype):
    """JAX's optimizer state as the port's, the moments in ``dtype``."""
    def conv(tree):
        f32 = jax.tree.map(lambda a: a.astype(jnp.float32), tree)
        return T.map_(lambda t: t.to(dtype), to_port(f32, tcfg))
    return {"m": conv(js["m"]), "v": conv(js["v"]),
            "step": torch.tensor(int(js["step"]), dtype=torch.int32)}


def _run(model, moment_dtype, clip_norm):
    """JAX's and the port's trees after each of STEPS updates; each port
    update starts from JAX's params and state before it, so every step
    holds the update alone to JAX's."""
    jcfg, tcfg, params, grads = model
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=STEPS + 1,
              clip_norm=clip_norm)
    jcfg_o = jopt.AdamWConfig(**kw, moment_dtype=moment_dtype[0])
    tcfg_o = opt.AdamWConfig(**kw, moment_dtype=moment_dtype[1])
    jstate, jp = jopt.init(jcfg_o, params), params
    jupd = jax.jit(lambda g, s, p: jopt.update(jcfg_o, g, s, p))
    out = []
    for i in range(STEPS):
        g = grads[i % 2]
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
        tree = M.trainable(tp, tcfg)
        tstate = _port_state(jstate, tcfg, moment_dtype[1])
        jp, jstate, jm = jupd(g, jstate, jp)
        _, tstate, tm = opt.update(tcfg_o, to_port(g, tcfg), tstate, tree)
        out.append((jp, jstate, jm, tree, tstate, tm))
    return out, tp


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1e3, 0.05])
def test_update_vs_jax(model, moments, clip_norm):
    jcfg, tcfg, _, _ = model
    dt = (getattr(jnp, moments), getattr(torch, moments))
    steps, tp = _run(model, dt, clip_norm)
    for i, (jp, js, jm, tree, ts, tm) in enumerate(steps):
        where = f"step {i + 1}"
        assert_leaves_close(tree, to_port(jp, tcfg), REL, where)
        for k in ("m", "v"):
            got = T.leaves(ts[k])
            assert all(g.dtype == dt[1] for g in got)
            want = to_port(jax.tree.map(lambda a: a.astype(jnp.float32),
                                        js[k]), tcfg)
            if moments == "float32":
                assert_leaves_close(ts[k], want, REL, f"{where} {k}")
                continue
            for a, b in zip(got, T.leaves(want), strict=True):
                a, b = np_(a), np_(b)
                assert np.all(np.abs(a - b) <= BF16_STEP * np.abs(b)), where
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        clipped = float(jm["grad_norm"]) > clip_norm
        assert clipped == (clip_norm < 1)        # both regimes are run
    # the tied head is the updated embedding, transposed (a view)
    assert tp["head"]["w"].data_ptr() == tp["embed"]["w"].data_ptr()
    np.testing.assert_array_equal(np_(tp["head"]["w"]),
                                  np_(tp["embed"]["w"]).T)


def test_schedule_and_global_norm(model):
    jcfg, tcfg, _, grads = model
    cfg_kw = dict(lr_peak=3e-3, warmup_steps=4, total_steps=12)
    for step in range(16):
        want = float(jopt.schedule(jopt.AdamWConfig(**cfg_kw),
                                   jnp.asarray(step, jnp.int32)))
        got = float(opt.schedule(opt.AdamWConfig(**cfg_kw),
                                 torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(
        float(opt.global_norm(to_port(grads[0], tcfg))),
        float(jopt.global_norm(grads[0])), rtol=1e-6)


def _jax_shaped(tree):
    """A JAX tree's leaves as tensors in the JAX nesting (stacked layer
    periods stay stacked): compression quantizes each leaf with one
    scale, so only trees of the same leaves give the same bits."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_compress_roundtrip_bit_equal(model):
    """Two round trips over JAX's gradient tree, the error state
    carried: the int8 words, the scales, the dequantized gradients and
    the residuals bit-equal."""
    jcfg, tcfg, params, grads = model
    jerr = jcompress.init_state(params)
    terr = compress.init_state(_jax_shaped(params))
    def is_cell(c):
        return isinstance(c, dict) and set(c) == {"q", "scale"}
    for g in grads:
        jwire, jerr = jcompress.compress(g, jerr)
        jhat = jcompress.decompress(jwire)
        tg = _jax_shaped(g)
        twire, terr_new = compress.compress(tg, terr)
        that = compress.decompress(twire)
        for got, want in ((that, jhat), (terr_new, jerr)):
            for a, b in zip(T.leaves(got), jax.tree.leaves(want),
                            strict=True):
                np.testing.assert_array_equal(np_(a), np.asarray(b))
        jcells = jax.tree.leaves(jwire, is_leaf=is_cell)
        twords = T.leaves(twire)          # each cell's q, then its scale
        assert len(twords) == 2 * len(jcells)
        for q, sc, jc in zip(twords[0::2], twords[1::2], jcells):
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(jc["q"]))
            np.testing.assert_array_equal(sc.numpy(), np.asarray(jc["scale"]))
        hat2, _ = compress.roundtrip(tg, terr)
        for a, b in zip(T.leaves(hat2), T.leaves(that)):
            np.testing.assert_array_equal(np_(a), np_(b))
        terr = terr_new


def test_wire_bytes_equal(model):
    """Equal on JAX's tree; the port's trainable tree holds the same
    parameters (one leaf a layer, so 4 more scale bytes a layer leaf)."""
    jcfg, tcfg, params, _ = model
    assert compress.wire_bytes(_jax_shaped(params)) == \
        jcompress.wire_bytes(params)
    tree = M.trainable(params_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg), tcfg)
    assert compress.wire_bytes(tree)["raw_fp32"] == \
        jcompress.wire_bytes(params)["raw_fp32"]
