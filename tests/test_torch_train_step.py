"""Training on the reduced bnn-lm-100m (``bnn_train``) against the JAX
package, from JAX's weights carried across: ``loss_fn`` with a loss
chunk shorter than the sequence (so the last chunk is padded with
masked labels) and every leaf's gradient within 1e-5 of the leaf's
largest element (the tied head's gradient lands on the embedding in
both); one ``build_train_step`` step with 1 and 2 microbatches against
JAX's (loss and gradient norm within 1e-5 relative, parameters within
JAX's own microbatch bound, rtol 5e-3 / atol 1e-3 at lr 1e-2, scaled to
this lr); and remat on equal to remat off."""
import jax
import numpy as np
import pytest
import torch

from _torch_train import (assert_leaves_close, batch_np, cfgs, np_,
                          to_port, to_torch_batch)
from repro.launch import steps as jsteps
from repro.models import transformer as JM
from repro.optim import optimizer as jopt
from repro_torch import tree as T
from repro_torch.interop import params_from_numpy
from repro_torch.launch import steps
from repro_torch.models import transformer as M
from repro_torch.optim import optimizer as opt

torch.set_num_threads(1)

GRAD_REL = 1e-5
LR = 1e-3
# JAX's tests/test_e2e.py bound for a microbatched step at lr 1e-2,
# scaled to LR: Adam's first step turns a near-zero gradient element's
# rounding into a move of about lr
PARAM_TOL = dict(rtol=5e-3, atol=1e-3 * LR / 1e-2)
B, T_SEQ, CHUNK = 4, 24, 16


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = cfgs("bnn-lm-100m", "bnn_train")
    params, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    batch = batch_np(jcfg.vocab, B, T_SEQ, 11)
    batch["labels"][0, -3:] = -1            # masked labels in the data too
    return jcfg, tcfg, params, batch


def _port(setup):
    jcfg, tcfg, params, batch = setup
    return params_from_numpy(jax.tree.map(np.asarray, params), tcfg)


def test_loss_and_grads_vs_jax(setup):
    jcfg, tcfg, params, batch = setup
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b, loss_chunk=CHUNK),
        has_aux=True))(params, batch)
    tp = _port(setup)
    loss, m, grads = steps.value_and_grad(tp, tcfg, to_torch_batch(batch),
                                          loss_chunk=CHUNK, remat=False)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]),
                               rtol=1e-6)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0     # no MoE layer
    assert "head" not in grads                             # tied
    assert_leaves_close(grads, to_port(jg, tcfg), GRAD_REL)
    # remat recomputes the same ops: the same bits
    _, _, grads_r = steps.value_and_grad(tp, tcfg, to_torch_batch(batch),
                                         loss_chunk=CHUNK, remat=True)
    for a, b in zip(T.leaves(grads_r), T.leaves(grads)):
        np.testing.assert_array_equal(np_(a), np_(b))
    # the flags are as they were
    assert not any(l.requires_grad for l in T.leaves(tp))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_vs_jax(setup, microbatches):
    jcfg, tcfg, params, batch = setup
    kw = dict(lr_peak=LR, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jsteps.build_train_step(
        jcfg, jopt.AdamWConfig(**kw), microbatches=microbatches,
        loss_chunk=CHUNK))
    jp, _, jm = jstep(params, jopt.init(jopt.AdamWConfig(**kw), params),
                      batch)
    tp = _port(setup)
    ocfg = opt.AdamWConfig(**kw)
    state = opt.init(ocfg, M.trainable(tp, tcfg))
    step = steps.build_train_step(tcfg, ocfg, microbatches=microbatches,
                                  loss_chunk=CHUNK)
    tp2, state, tm = step(tp, state, to_torch_batch(batch))
    assert tp2 is tp and int(state["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for a, b in zip(T.leaves(M.trainable(tp, tcfg)),
                    T.leaves(to_port(jp, tcfg)), strict=True):
        np.testing.assert_allclose(np_(a), np_(b), **PARAM_TOL)
    # the tied head is the trained embedding
    np.testing.assert_array_equal(np_(tp["head"]["w"]),
                                  np_(tp["embed"]["w"]).T)


def test_microbatches_match_one_batch(setup):
    """Accumulating 2 microbatches equals one batch (linearity, with no
    masked label: each microbatch averages over its own labels): loss
    and gradient norm within 1e-5, parameters within PARAM_TOL."""
    jcfg, tcfg, params, _ = setup
    batch = batch_np(jcfg.vocab, B, T_SEQ, 12)
    ocfg = opt.AdamWConfig(lr_peak=LR, warmup_steps=0, total_steps=10)
    out = {}
    for mb in (1, 2):
        tp = _port(setup)
        state = opt.init(ocfg, M.trainable(tp, tcfg))
        _, _, m = steps.build_train_step(tcfg, ocfg, microbatches=mb,
                                         loss_chunk=CHUNK)(
            tp, state, to_torch_batch(batch))
        out[mb] = (tp, float(m["loss"]), float(m["grad_norm"]))
    np.testing.assert_allclose(out[2][1], out[1][1], rtol=1e-5)
    np.testing.assert_allclose(out[2][2], out[1][2], rtol=1e-5)
    for a, b in zip(T.leaves(out[2][0]), T.leaves(out[1][0])):
        np.testing.assert_allclose(np_(a), np_(b), **PARAM_TOL)
