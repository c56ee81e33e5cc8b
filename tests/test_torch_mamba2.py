"""Port layer: the Mamba-2 SSD mixer (``repro_torch.layers.mamba2``)
against the JAX package's ``repro.layers.mamba2`` on its XLA path.

Reduced shapes (d_model 64, headdim 8, state 16, conv 4: 16 heads,
d_inner 128), inputs and the free parameters (conv bias, dt bias, D,
the norm scale) drawn from a numpy seed, the projections from the JAX
init; each check at precision "bf16" (float matmul) and "bnn" (the
packed XNOR-popcount GEMM's plain version).  Tolerance rtol = atol =
1e-4 (float32; the SSD's sums are associated differently on the two
sides, and the dual form differs from the recurrence by rounding)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.layers import mamba2 as J
from repro_torch.configs.base import ArchConfig
from repro_torch.interop import _tensors
from repro_torch.layers import mamba2 as T

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
PRECISIONS = ("bf16", "bnn")
JCFG = jreduced(jconfigs.get_config("mamba2-1.3b"))
TCFG = ArchConfig(**dataclasses.asdict(JCFG))
D_INNER, H, N, CONV_CH = T._dims(TCFG)
CHUNK = 8


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture(scope="module")
def params():
    """(JAX params, port params): the same numbers on both sides."""
    jp, _ = J.init(jax.random.PRNGKey(0), JCFG)
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(1)
    jp["conv_b"] = rng.standard_normal(CONV_CH).astype(np.float32) * 0.1
    jp["dt_bias"] = rng.standard_normal(H).astype(np.float32) * 0.5
    jp["D"] = rng.standard_normal(H).astype(np.float32)
    jp["norm"]["scale"] = 1.0 + 0.2 * rng.standard_normal(
        D_INNER).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), _tensors(jp, "cpu")


def _x(b, t, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (b, t, TCFG.d_model)).astype(np.float32)


def _pool(num_slots, seed=3):
    """A slot pool with nonzero state in every slot, numpy."""
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((num_slots, H, N, TCFG.ssm_headdim)
                                     ).astype(np.float32) * 0.3,
            "conv": rng.standard_normal((num_slots, TCFG.ssm_conv - 1,
                                         CONV_CH)).astype(np.float32)}


def test_init_matches_jax_layout():
    """Same leaves, shapes and fixed values as the JAX init."""
    jp, _ = J.init(jax.random.PRNGKey(0), JCFG)
    tp = T.init(torch.Generator().manual_seed(0), TCFG)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jp))
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in flat_j.items():
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
    for name in ("conv_b", "D", "dt_bias"):
        np.testing.assert_array_equal(_np(tp[name]), np.asarray(jp[name]))
    np.testing.assert_allclose(_np(tp["A_log"]), np.asarray(jp["A_log"]),
                               rtol=1e-6)
    assert abs(float(tp["conv_w"].std()) - 0.2) < 0.02


def test_split_and_causal_conv_match_jax(params):
    jp, tp = params
    zx = np.random.default_rng(4).standard_normal(
        (2, 11, 2 * D_INNER + 2 * N + H)).astype(np.float32)
    got = T._split_proj(TCFG, torch.from_numpy(zx))
    want = J._split_proj(JCFG, jnp.asarray(zx))
    for g, w in zip(got, want, strict=True):
        if isinstance(w, int):
            assert g == w
        else:
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    xbc = torch.from_numpy(zx[..., D_INNER:D_INNER + CONV_CH].copy())
    np.testing.assert_allclose(
        _np(T._causal_conv(xbc, tp["conv_w"], tp["conv_b"])),
        np.asarray(J._causal_conv(jnp.asarray(_np(xbc)), jp["conv_w"],
                                  jp["conv_b"])), **TOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_forward_matches_jax(params, precision):
    """The chunked SSD, 21 positions in chunks of 8 (the last padded)."""
    jp, tp = params
    x = _x(2, 21)
    got = T.forward(tp, TCFG, torch.from_numpy(x), chunk=CHUNK,
                    precision=precision)
    want = J.forward(jp, JCFG, jnp.asarray(x), chunk=CHUNK,
                     precision=precision)
    assert got.shape == (2, 21, TCFG.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _jax_recurrence(jp, x, precision):
    """The JAX package's O(T) recurrence at ``precision``: its
    ``forward_reference`` (float projections) or, at "bnn", its
    ``decode_step`` one position at a time."""
    if precision == "bf16":
        return np.asarray(J.forward_reference(jp, JCFG, jnp.asarray(x)))
    cache = J.init_cache(JCFG, x.shape[0])
    outs = []
    for i in range(x.shape[1]):
        y, cache = J.decode_step(jp, JCFG, jnp.asarray(x[:, i:i + 1]), cache,
                                 precision=precision)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_forward_reference_matches_jax(params, precision):
    jp, tp = params
    x = _x(2, 13, seed=5)
    got = T.forward_reference(tp, TCFG, torch.from_numpy(x),
                              precision=precision)
    np.testing.assert_allclose(_np(got), _jax_recurrence(jp, x, precision),
                               **TOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_forward_matches_own_reference(params, precision):
    """The dual form against the recurrence, both in the port."""
    _jp, tp = params
    x = torch.from_numpy(_x(2, 21, seed=6))
    np.testing.assert_allclose(
        _np(T.forward(tp, TCFG, x, chunk=CHUNK, precision=precision)),
        _np(T.forward_reference(tp, TCFG, x, precision=precision)), **TOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_decode_steps_match_jax(params, precision):
    """Nine decode steps from ``init_cache``: outputs and the cache."""
    jp, tp = params
    x = _x(3, 9, seed=7)
    jc = J.init_cache(JCFG, 3)
    tc = T.init_cache(TCFG, 3)
    for i in range(x.shape[1]):
        xi = x[:, i:i + 1]
        jy, jc = J.decode_step(jp, JCFG, jnp.asarray(xi), jc,
                               precision=precision)
        ty, tc = T.decode_step(tp, TCFG, torch.from_numpy(xi), tc,
                               precision=precision)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]), **TOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_prefill_chunk_matches_jax(params, precision):
    """Two chunks of 8 over a carried nonzero state, rows with n_valid 0,
    1, 2 and the whole chunk (then the reverse): outputs at every
    position and both pool leaves (scratch slot 0 excluded, which the
    n_valid = 0 rows write)."""
    jp, tp = params
    pool = _pool(6)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    slots = np.array([2, 5, 1, 3], np.int32)
    x = _x(4, 2 * CHUNK, seed=8)
    h_before = tpool["h"]
    for c, n_valid in enumerate(([0, 1, 2, CHUNK], [CHUNK, 2, 1, 0])):
        xc = x[:, c * CHUNK:(c + 1) * CHUNK]
        nv = np.array(n_valid, np.int32)
        ty, tpool = T.prefill_chunk(tp, TCFG, torch.from_numpy(xc), tpool,
                                    torch.from_numpy(slots),
                                    torch.from_numpy(nv),
                                    precision=precision)
        jy, jpool = J.prefill_chunk(jp, JCFG, jnp.asarray(xc), jpool,
                                    jnp.asarray(slots), jnp.asarray(nv),
                                    precision=precision)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(_np(tpool[k])[1:],
                                       np.asarray(jpool[k])[1:], **TOL)
    assert tpool["h"] is h_before                # written in place
    # slot 4 belongs to no row: untouched
    np.testing.assert_array_equal(_np(tpool["h"])[4], pool["h"][4])


@pytest.mark.parametrize("precision", PRECISIONS)
def test_paged_decode_step_matches_jax(params, precision):
    """Three decode steps against the slot pool with one inactive row
    (it writes to scratch slot 0 only): outputs and the pool."""
    jp, tp = params
    pool = _pool(5, seed=9)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    slots = np.array([3, 1, 4, 2], np.int32)
    active = np.array([True, False, True, True])
    x = _x(4, 3, seed=10)
    for i in range(3):
        xi = x[:, i:i + 1]
        ty, tpool = T.paged_decode_step(
            tp, TCFG, torch.from_numpy(xi), tpool, torch.from_numpy(slots),
            precision=precision, active=torch.from_numpy(active))
        jy, jpool = J.paged_decode_step(
            jp, JCFG, jnp.asarray(xi), jpool, jnp.asarray(slots),
            precision=precision, active=jnp.asarray(active))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(_np(tpool[k])[1:],
                                       np.asarray(jpool[k])[1:], **TOL)
    # the inactive row's slot 1 kept its state
    np.testing.assert_array_equal(_np(tpool["conv"])[1], pool["conv"][1])
