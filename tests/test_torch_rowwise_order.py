"""The fixed orders of the row-wise ops (``kernels/rowwise.py``) written
out a second time, as scalar numpy float32 walks (one ``np.float32`` op
at a time), and held bit-equal to the plain versions the kernels are
checked against on the card:

* ``row_gemm``: K in chunks of KC; each chunk's partial over its k
  ascending from +0.0, then the partials in ascending chunk order from
  +0.0, at K around the chunk (KC - 1, KC, KC + 1, 2 KC + 37);
* ``row_norm``: 32 W lanes, W = warps(D) = min(8, ceil(D / 1024)), each
  lane's 4-element chunks in turn, each warp's xor butterfly, the warp
  totals in ascending order, at D around the warps (1024, 1025, 2050,
  4100);
* where the orders met the single chain and the single warp they
  replaced (K <= KC, D <= 1024), the bits did not move: the former
  formulas are kept here and compared;
* the constants are the kernels' (``csrc/row_gemm.cu``,
  ``csrc/row_norm.cu``)."""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib, rowwise as rw

torch.set_num_threads(1)

f32 = np.float32


def _gemm_data(m, k, n, seed, tied=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(f32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(f32)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).t() if tied else \
        torch.from_numpy(w)
    return x, w, torch.from_numpy(x), wt


def _gemm_walk(x, w):
    """y[m, n] = +0 + P_0 + P_1 + ..., P_c the chain over chunk c's k."""
    m_, k_ = x.shape
    n_ = w.shape[1]
    y = np.zeros((m_, n_), f32)
    for m in range(m_):
        for n in range(n_):
            total = f32(0.0)
            for c0 in range(0, k_, rw.KC):
                p = f32(0.0)
                for k in range(c0, min(c0 + rw.KC, k_)):
                    p = f32(p + f32(x[m, k] * w[k, n]))
                total = f32(total + p)
            y[m, n] = total
    return y


@pytest.mark.parametrize("k", [rw.KC - 1, rw.KC, rw.KC + 1,
                               2 * rw.KC + 37])
@pytest.mark.parametrize("tied", [False, True], ids=["dense", "tied"])
def test_row_gemm_equals_the_chunked_walk(k, tied):
    x, w, xt, wt = _gemm_data(2, k, 3, seed=k, tied=tied)
    got = rw.row_gemm_torch(xt, wt).numpy()
    np.testing.assert_array_equal(got, _gemm_walk(x, w))


def _single_chain(x, w):
    """The order before the chunks: one chain over all of K."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for i in range(x.shape[1]):
        acc.add_(torch.mul(x[:, i, None], w[i]))
    return acc


@pytest.mark.parametrize("k", [1, 64, rw.KC - 1, rw.KC])
def test_row_gemm_up_to_a_chunk_keeps_the_single_chain(k):
    _, _, x, w = _gemm_data(5, k, 33, seed=100 + k)
    assert torch.equal(rw.row_gemm_torch(x, w), _single_chain(x, w))


def test_row_gemm_past_a_chunk_leaves_the_single_chain():
    # the chunked order is another order: over 2 KC + 37 terms some of
    # these 5 x 33 sums round differently from the single chain
    _, _, x, w = _gemm_data(5, 2 * rw.KC + 37, 33, seed=7)
    got = rw.row_gemm_torch(x, w)
    assert not torch.equal(got, _single_chain(x, w))
    np.testing.assert_allclose(got.numpy(), _single_chain(x, w).numpy(),
                               rtol=1e-5, atol=1e-5)


def _norm_data(m, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, d)) * 3 + 0.5).astype(f32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(f32)
    bias = (0.1 * rng.standard_normal(d)).astype(f32)
    return x, scale, bias


def _row_sum_walk(v):
    """A row's sum in the kernel's order, scalar by scalar."""
    d = len(v)
    nw = rw.warps(d)
    lanes = 32 * nw
    chunks = -(-d // 4)
    s = [f32(0.0)] * lanes
    for lane in range(lanes):
        for c in range(lane, chunks, lanes):
            for e in range(4):
                i = 4 * c + e
                s[lane] = f32(s[lane] + (v[i] if i < d else f32(0.0)))
    o = 16
    while o:
        s = [f32(s[lane] + s[lane ^ o]) for lane in range(lanes)]
        o //= 2
    if nw == 1:
        return s[0]
    total = f32(0.0)
    for w in range(nw):
        total = f32(total + s[32 * w])
    return total


def _norm_walk(x, scale, bias, eps, layer):
    d = x.shape[1]
    out = np.zeros_like(x)
    for m, row in enumerate(x):
        if layer:
            mu = f32(_row_sum_walk(row) / f32(d))
            xc = np.array([f32(a - mu) for a in row], f32)
        else:
            xc = row
        var = f32(_row_sum_walk(np.array([f32(a * a) for a in xc], f32))
                  / f32(d))
        r = f32(f32(1.0) / f32(np.sqrt(f32(var + f32(eps)))))
        for i in range(d):
            y = f32(f32(xc[i] * r) * scale[i])
            out[m, i] = f32(y + bias[i]) if layer else y
    return out


@pytest.mark.parametrize("d", [1024, 1025, 2050, 4100])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_row_norm_equals_the_warp_walk(d, kind):
    x, scale, bias = _norm_data(2, d, seed=d)
    layer = kind == "layernorm"
    eps = 1e-5 if layer else 1e-6
    got = rw.row_norm_torch(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias) if layer else None, eps,
                            layer).numpy()
    np.testing.assert_array_equal(
        got, _norm_walk(x, scale, bias, eps, layer))


def _one_warp_sums(v):
    """The order before wider rows got a block: one warp, 32 lanes."""
    m, d = v.shape
    pad = (-d) % 128
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(m, -1, 32, 4)
    acc = torch.zeros((m, 32), dtype=torch.float32)
    for j in range(v.shape[1]):
        for e in range(4):
            acc = acc + v[:, j, :, e]
    lanes = torch.arange(32)
    o = 16
    while o:
        acc = acc + acc[:, lanes ^ o]
        o //= 2
    return acc[:, :1]


@pytest.mark.parametrize("d", [7, 64, 768, 1000, 1024])
def test_row_norm_up_to_a_warp_keeps_the_one_warp_order(d):
    x = torch.from_numpy(_norm_data(4, d, seed=d)[0])
    assert torch.equal(rw._lane_sums(x), _one_warp_sums(x))
    assert torch.equal(rw._lane_sums(x * x), _one_warp_sums(x * x))


def test_warps_of_a_row():
    assert [rw.warps(d) for d in (1, 1024, 1025, 2048, 2050, 4100, 8191,
                                  8192, 8193, 16384)] == \
        [1, 1, 2, 2, 3, 5, 8, 8, 8, 8]


def test_constants_are_the_kernels():
    gemm = (_lib.CSRC / "row_gemm.cu").read_text()
    norm = (_lib.CSRC / "row_norm.cu").read_text()
    assert int(re.search(r"constexpr int KC = (\d+);", gemm)[1]) == rw.KC
    assert int(re.search(r"constexpr int LANE_SPAN = (\d+);", norm)[1]) == \
        rw.LANE_SPAN
    assert int(re.search(r"constexpr int MAX_WARPS = (\d+);", norm)[1]) == \
        rw.MAX_WARPS
