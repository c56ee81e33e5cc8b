"""The fixed-order row-wise ops (``kernels/rowwise.py``) on the CPU: the
plain ``row_gemm`` and ``row_norm`` give each row the same bits whatever
rows run beside it (M = 1, 3, 8, 128, the row at several positions) and
``row_gemm`` each column the same bits in any slice of the columns (the
tied head's transposed layout too: a model rank's vocab slice); both
equal the JAX package's einsum, rmsnorm and layernorm within TOL (float32
sums of at most 4096 terms of O(1) results, in another order); their
``autograd.Function`` gradients equal autograd through the plain
version within GRAD_TOL (the backward is library matmuls and the
library formula); on ``meta`` each makes its output alone; dispatch
never falls back.  The kernels themselves are held bit-equal to these
plain versions on the card by ``chip_smoke.py``'s phase 2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import common as jcommon
from repro_torch.kernels import _lib, ops, rowwise as rw

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)       # vs JAX: another order of the sums
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)  # Function vs autograd of the plain
ROWS = (1, 3, 8, 128)


def _data(m, k, n, seed=0, tied=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    xt = torch.from_numpy(x)
    # the tied head: the embedding (N, K) read transposed, strides (1, K)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).t() if tied else \
        torch.from_numpy(w)
    return x, w, xt, wt


def _rows_alone(k, n, tied):
    _, _, x, w = _data(128, k, n, tied=tied)
    assert w.stride() == ((1, k) if tied else (n, 1))
    whole = rw.row_gemm_torch(x, w)
    for m in ROWS:
        for start in {0, (128 - m) // 2, 128 - m}:
            got = rw.row_gemm_torch(x[start:start + m], w)
            assert torch.equal(got, whole[start:start + m]), (m, start)


def _columns_alone(k, tied):
    _, _, x, w = _data(8, k, 128, seed=1, tied=tied)
    whole = rw.row_gemm_torch(x, w)
    for a, b in ((0, 64), (64, 128), (32, 96), (5, 6), (0, 128)):
        assert torch.equal(rw.row_gemm_torch(x, w[:, a:b]), whole[:, a:b])


@pytest.mark.parametrize("tied", [False, True], ids=["dense", "tied"])
def test_row_gemm_row_bits_do_not_depend_on_m(tied):
    _rows_alone(64, 96, tied)


@pytest.mark.parametrize("tied", [False, True], ids=["dense", "tied"])
def test_row_gemm_column_slices_equal_the_whole(tied):
    _columns_alone(64, tied)


# K over several chunks of the order (2 KC + 37: two whole, one partial)
@pytest.mark.parametrize("tied", [False, True], ids=["dense", "tied"])
def test_row_gemm_chunked_row_bits_do_not_depend_on_m(tied):
    _rows_alone(2 * rw.KC + 37, 24, tied)


@pytest.mark.parametrize("tied", [False, True], ids=["dense", "tied"])
def test_row_gemm_chunked_column_slices_equal_the_whole(tied):
    _columns_alone(2 * rw.KC + 37, tied)


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (24, 64, 128),
                                   (8, 768, 320), (5, 100, 7),
                                   (6, 2 * rw.KC + 37, 40)])
def test_row_gemm_equals_the_jax_einsum(m, k, n):
    xn, wn, x, w = _data(m, k, n, seed=2)
    want = np.asarray(jnp.einsum("td,de->te", jnp.asarray(xn),
                                 jnp.asarray(wn)))
    got = ops.row_gemm(x, w)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # leading dims carried: (B, T, K) as the head takes them
    got3 = ops.row_gemm(x.reshape(1, m, k), w)
    assert torch.equal(got3.reshape(m, n), got)


@pytest.mark.parametrize("tied", [False, True], ids=["dense", "tied"])
def test_row_gemm_gradients_equal_autograd_of_the_plain(tied):
    _, _, x, w = _data(6, 64, 40, seed=3, tied=tied)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (6, 40)).astype(np.float32))
    xa, wa = x.clone().requires_grad_(), w.detach().clone().requires_grad_()
    (rw.row_gemm_torch(xa, wa) * dy).sum().backward()
    xb, wb = x.clone().requires_grad_(), w.detach().clone().requires_grad_()
    y = ops.row_gemm(xb, wb)
    assert torch.equal(y.detach(), rw.row_gemm_torch(x, w))
    (y * dy).sum().backward()
    for a, b in ((xa.grad, xb.grad), (wa.grad, wb.grad)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **GRAD_TOL)


def _norm_data(m, d, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, d)) * 3 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("d", [64, 100, 768, 4096])
def test_row_norm_row_bits_do_not_depend_on_m(kind, d):
    x, scale, bias = map(torch.from_numpy, _norm_data(128, d))
    b = bias if kind == "layernorm" else None
    layer = kind == "layernorm"
    whole = rw.row_norm_torch(x, scale, b, 1e-6, layer)
    for m in ROWS:
        for start in {0, (128 - m) // 2, 128 - m}:
            got = rw.row_norm_torch(x[start:start + m], scale, b, 1e-6,
                                    layer)
            assert torch.equal(got, whole[start:start + m]), (m, start)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("d", [64, 100, 768, 4096])
def test_row_norm_equals_jax(kind, d):
    xn, sn, bn = _norm_data(5, d, seed=5)
    p = {"scale": sn} if kind == "rmsnorm" else {"scale": sn, "bias": bn}
    eps = 1e-6 if kind == "rmsnorm" else 1e-5
    want = np.asarray(jcommon.norm(jnp.asarray(xn), {k: jnp.asarray(v)
                                                     for k, v in p.items()},
                                   kind, eps))
    got = ops.row_norm(torch.from_numpy(xn), torch.from_numpy(sn),
                       torch.from_numpy(bn) if kind == "layernorm" else None,
                       eps=eps, kind=kind)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_row_norm_gradients_equal_autograd_of_the_plain(kind):
    x, scale, bias = map(torch.from_numpy, _norm_data(7, 100, seed=6))
    layer = kind == "layernorm"
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (7, 100)).astype(np.float32))

    def leaves():
        return [t.clone().requires_grad_() for t in (x, scale, bias)]
    a = leaves()
    (rw.row_norm_torch(a[0], a[1], a[2] if layer else None, 1e-6, layer)
     * dy).sum().backward()
    b = leaves()
    y = ops.row_norm(b[0], b[1], b[2] if layer else None, eps=1e-6,
                     kind=kind)
    assert torch.equal(y.detach(), rw.row_norm_torch(
        x, scale, bias if layer else None, 1e-6, layer))
    (y * dy).sum().backward()
    for ta, tb in zip(a[:3 if layer else 2], b):
        np.testing.assert_allclose(tb.grad.numpy(), ta.grad.numpy(),
                                   **GRAD_TOL)
    if not layer:
        assert b[2].grad is None


def test_meta_outputs_alone_and_no_fallback():
    x = torch.empty((4, 64), device="meta")
    assert ops.row_gemm(x, torch.empty((64, 10), device="meta")).shape == \
        (4, 10)
    assert ops.row_norm(x, torch.empty(64, device="meta")).shape == (4, 64)
    with pytest.raises(ValueError):
        ops.row_gemm(torch.zeros(2, 3), torch.zeros(3, 4), impl="cuda")
    with pytest.raises(ValueError):
        ops.row_norm(torch.zeros(2, 3), torch.ones(3), impl="cuda")
    with pytest.raises(ValueError):
        rw.row_gemm_cuda(torch.zeros(2, 3), torch.zeros(3, 4))
    with pytest.raises(ValueError):
        rw.row_norm_cuda(torch.zeros(2, 3), torch.ones(3), None, 1e-6, False)
    with pytest.raises(ValueError):
        ops.row_norm(torch.zeros(2, 3), torch.ones(3), kind="batchnorm")


def test_kernels_registered_with_their_entry_points():
    names = {k.name: k for k in ops.KERNELS}
    for name, entry in (("row_gemm", "rg_row_gemm"),
                        ("row_norm", "rn_row_norm")):
        k = names[name]
        assert (_lib.REPO / k.source).exists()
        assert entry in _lib._SIGNATURES
        assert entry in (_lib.REPO / k.source).read_text()
        for ref in k.replaces.split("; "):
            path = ref.split(":")[0]
            assert (_lib.REPO / path).exists()
