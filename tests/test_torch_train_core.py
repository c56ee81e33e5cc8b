"""The STE-binarized training GEMMs of the port against the JAX
package: ``core/xnor.bnn_matmul_train`` (values and gradients, alpha on
and off, the straight-through mask at |x| = 1 and sign(0) = +1),
``ops.bnn_dense`` and ``ops.expert_dense`` at ``bnn_train`` (the JAX
``bnn_dense`` and ``moe._expert_matmul``), and ``core/conv.bnn_conv2d``
at ``bnn_train`` with both ``scale`` values; and the reference's border
quirk: at ``bnn_train`` the SAME padding's zeros count as +1, so its
border outputs differ from the bnn path's (ROADMAP.md queue 3).

Inputs are numpy arrays from a fixed seed with entries set to exactly
0, +-1 and just past +-1; the gradients are of sum(y * r) for a fixed
random r."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv as jconv, xnor as jxnor
from repro.kernels import ops as jops
from repro.layers import moe as jmoe
from repro_torch.core import conv, xnor
from repro_torch.kernels import ops

torch.set_num_threads(1)

VAL_TOL = dict(rtol=1e-6, atol=1e-6)      # float32 sums of +-1 times alpha
GRAD_REL = 1e-6     # |gradient - JAX's| <= this x the largest |element|:
                    # the backward sums many float32 terms in its own order


def _edges(a: np.ndarray) -> np.ndarray:
    """Exactly 0, +-1 and +-(1 + 1e-6) at the first entries: sign(0) =
    +1 and the STE mask's edge (|x| <= 1 passes)."""
    flat = a.reshape(-1)
    flat[:6] = (0.0, 1.0, -1.0, 1.0 + 1e-6, -1.0 - 1e-6, 0.5)
    return a


def _inputs(shape_x, shape_w, seed):
    rng = np.random.default_rng(seed)
    x = _edges(rng.standard_normal(shape_x).astype(np.float32))
    w = _edges((rng.standard_normal(shape_w) * 0.8).astype(np.float32))
    return x, w


def _jax_vg(fn, x, w, r):
    def loss(x, w):
        y = fn(x, w)
        return jnp.sum(y * r), y
    (_, y), (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(x, w)
    return np.asarray(y), np.asarray(gx), np.asarray(gw)


def _torch_vg(fn, x, w, r):
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    wt = torch.from_numpy(w.copy()).requires_grad_(True)
    y = fn(xt, wt)
    gx, gw = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)),
                                 (xt, wt))
    return y.detach().numpy(), gx.numpy(), gw.numpy()


def _same(got, want):
    np.testing.assert_allclose(got[0], want[0], **VAL_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max())


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("m,k,n", [(5, 40, 7), (16, 96, 33)])
def test_bnn_matmul_train_vs_jax(scale, m, k, n):
    x, w = _inputs((m, k), (k, n), m + k + n)
    r = np.random.default_rng(1).standard_normal((m, n)).astype(np.float32)
    want = _jax_vg(lambda a, b: jxnor.bnn_matmul_train(a, b, scale=scale),
                   x, w, r)
    got = _torch_vg(lambda a, b: xnor.bnn_matmul_train(a, b, scale=scale),
                    x, w, r)
    _same(got, want)
    # the STE mask: no gradient reaches an entry past |x| = 1
    assert got[1].reshape(-1)[3] == 0 and got[1].reshape(-1)[4] == 0
    assert np.all(got[1][np.abs(x) > 1] == 0)
    if not scale:
        assert np.all(got[2][np.abs(w) > 1] == 0)
    else:     # alpha keeps w in the graph: sign(w)/K terms everywhere
        assert np.all(got[2][np.abs(w) > 1] != 0)


def test_bnn_dense_train_vs_jax():
    """(B, T, K) activations, reshaped to 2-D and back, both packages."""
    x, w = _inputs((2, 5, 48), (48, 24), 3)
    r = np.random.default_rng(2).standard_normal((2, 5, 24)).astype(
        np.float32)
    want = _jax_vg(lambda a, b: jops.bnn_dense(a, b, precision="bnn_train"),
                   x, w, r)
    got = _torch_vg(lambda a, b: ops.bnn_dense(a, b, precision="bnn_train"),
                    x, w, r)
    _same(got, want)


def test_expert_dense_train_vs_jax():
    """Every expert of an (E, din, dout) stack through ``expert_dense``
    against the JAX ``_expert_matmul`` over (E, C, din): alpha is the
    mean over din per expert and output column."""
    e, c, din, dout = 3, 6, 40, 20
    x, w = _inputs((e, c, din), (e, din, dout), 4)
    r = np.random.default_rng(3).standard_normal((e, c, dout)).astype(
        np.float32)
    want = _jax_vg(lambda a, b: jmoe._expert_matmul(a, b, "bnn_train"),
                   x, w, r)
    got = _torch_vg(lambda a, b: torch.stack([
        ops.expert_dense(a[i], b, i, precision="bnn_train")
        for i in range(e)]), x, w, r)
    _same(got, want)


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("k,stride,padding",
                         [(3, 1, "SAME"), (3, 2, "SAME"), (1, 1, "SAME"),
                          (3, 1, "VALID")])
def test_bnn_conv2d_train_vs_jax(scale, k, stride, padding):
    x, w = _inputs((2, 7, 6, 5), (k, k, 5, 8), k * 10 + stride)
    want_y = np.asarray(jconv.bnn_conv2d(jnp.asarray(x), jnp.asarray(w),
                                         stride=stride, padding=padding,
                                         precision="bnn_train", scale=scale))
    r = np.random.default_rng(5).standard_normal(want_y.shape).astype(
        np.float32)
    kw = dict(stride=stride, padding=padding, precision="bnn_train",
              scale=scale)
    want = _jax_vg(lambda a, b: jconv.bnn_conv2d(a, b, **kw), x, w, r)
    got = _torch_vg(lambda a, b: conv.bnn_conv2d(a, b, **kw), x, w, r)
    _same(got, want)


def test_bnn_conv2d_train_border_quirk():
    """The reference's training conv counts SAME-padded zeros as +1
    (ste_sign(0) = +1, no border correction); its inference conv
    subtracts them.  On tests/test_conv.py's train-grad shapes (1 x 6 x
    6 x 3, k 3, SAME) the two disagree on border outputs only, in both
    packages alike; inside they are equal, and bnn equals the sign-conv
    oracle everywhere."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    x = np.array(jax.random.normal(k1, (1, 6, 6, 3)))
    w = np.array(jax.random.normal(k2, (3, 3, 3, 4)) * 0.2)
    j_train = np.asarray(jconv.bnn_conv2d(x, w, precision="bnn_train"))
    j_bnn = np.asarray(jconv.bnn_conv2d(x, w, precision="bnn", impl="xla"))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    t_train = conv.bnn_conv2d(xt, wt, precision="bnn_train").numpy()
    t_bnn = conv.bnn_conv2d(xt, wt, precision="bnn").numpy()
    oracle = conv.reference_sign_conv2d(xt, wt).numpy()
    np.testing.assert_array_equal(t_train, j_train)
    np.testing.assert_array_equal(t_bnn, j_bnn)
    np.testing.assert_array_equal(t_bnn, oracle)
    differ = t_train != t_bnn
    border = np.ones((6, 6), bool)
    border[1:-1, 1:-1] = False
    assert not differ[0][~border].any()          # inside: equal
    assert differ[0][border].any()               # the border: not
    assert int(differ.sum()) == int((j_train != j_bnn).sum()) == 80
    assert differ.size == 144
