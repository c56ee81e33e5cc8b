"""Port MoE on the CPU against the JAX package: routing and dispatch
tables integer-exact, ties broken as ``lax.top_k`` breaks them, the
layer at finite capacity (the full-sequence path, JAX's drop order) and
drop-free (the serving path) at precision "bnn" and "bf16", with shared
experts and one or two dispatch groups; the routed-rows dispatch equal
to the capacity table at drop-free capacity; the dense reference; and
the expert-stack pack cache (one pack per stack, not per expert view).

Weights are the reduced mixtral and deepseek-v2-lite MoE layers from
the JAX init.  Tolerances: router weights 1e-6; layer outputs 1e-4
(float32, as tests/test_torch_model.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.layers import moe as jmoe
from repro.models import transformer as JM
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.layers import moe

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {"swa": "mixtral-8x7b", "mla": "deepseek-v2-lite-16b"}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def moe_layers():
    """family -> (jax cfg, jax MoE params, port cfg, port MoE params) of
    the first MoE layer; deepseek's has shared experts."""
    out = {}
    for fam, arch in ARCHS.items():
        jcfg = jreduced(jconfigs.get_config(arch)).replace(precision="bnn")
        tcfg = treduced(tconfigs.get_config(arch)).replace(precision="bnn")
        jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
        li = [f for _m, f in JM.layer_plan(jcfg)].index("moe")
        out[fam] = (jcfg, list(JM._iter_layers(jcfg, jp))[li][2]["ffn"],
                    tcfg, tp["layers"][li]["ffn"])
    return out


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("fam", list(ARCHS))
def test_route_and_dispatch_tables_match_jax(moe_layers, fam):
    jcfg, jp, tcfg, tp = moe_layers[fam]
    x = _x((24, 64), 1)
    jw, je, jaux = jmoe.route(jnp.asarray(x), jp["router"]["w"], jcfg.top_k)
    tw, te, taux = moe.route(_t(x), tp["router"]["w"], tcfg.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    e = tcfg.n_experts
    for cap in (1, 3, 8, 24 * tcfg.top_k):
        jt = jmoe.dispatch_tables(je, e, cap)
        tt = moe.dispatch_tables(te, e, cap)
        for g, w in zip(tt, jt, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_route_breaks_ties_as_lax_top_k():
    """All-equal router probabilities: the lower expert wins each tie,
    on both sides (a stable descending sort, as lax.top_k)."""
    x = _x((5, 16), 2)
    w = np.zeros((16, 8), np.float32)
    w[:, 6] = 0.0
    _jw, je, _ = jmoe.route(jnp.asarray(x), jnp.asarray(w), 3)
    _tw, te, _ = moe.route(_t(x), _t(w), 3)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy(), np.tile([0, 1, 2], (5, 1)))
    # a partial tie: experts 2 and 5 share the top logit
    w[:, 2] = w[:, 5] = 1.0
    xp = np.abs(x)
    _jw, je, _ = jmoe.route(jnp.asarray(xp), jnp.asarray(w), 2)
    _tw, te, _ = moe.route(_t(xp), _t(w), 2)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy(), np.tile([2, 5], (5, 1)))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("precision", ["bnn", "bf16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.0])
@pytest.mark.parametrize("fam", list(ARCHS))
def test_moe_forward_matches_jax(moe_layers, fam, capacity_factor,
                                 precision, groups):
    jcfg, jp, tcfg, tp = moe_layers[fam]
    x = _x((2, 10, 64), 3)
    kw = dict(top_k=tcfg.top_k, kind=tcfg.act,
              capacity_factor=capacity_factor, precision=precision,
              dispatch_groups=groups)
    jy, jaux = jmoe.forward(jp, jnp.asarray(x), **kw)
    ty, taux = moe.forward(tp, _t(x), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_routed_rows_equal_capacity_table_drop_free(moe_layers, precision,
                                                    groups):
    """Drop-free capacity (T·k rows per expert) through the capacity
    table computes what the routed rows compute."""
    _jcfg, _jp, tcfg, tp = moe_layers["mla"]
    x = _t(_x((2, 6, 64), 4))
    k = tcfg.top_k
    kw = dict(top_k=k, kind=tcfg.act, precision=precision, impl="auto")
    routed, _ = moe._forward_routed(tp, x, taps=None, **kw)
    table, _ = moe._forward_tables(tp, x, capacity=12 // groups * k,
                                   groups=groups, **kw)
    np.testing.assert_allclose(table.numpy(), routed.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_moe_dense_reference_matches_jax(moe_layers):
    for fam in ARCHS:
        jcfg, jp, tcfg, tp = moe_layers[fam]
        x = _x((2, 5, 64), 5)
        want = jmoe.forward_dense_reference(jp, jnp.asarray(x),
                                            top_k=jcfg.top_k, kind=jcfg.act)
        got = moe.forward_dense_reference(tp, _t(x), top_k=tcfg.top_k,
                                          kind=tcfg.act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # and the drop-free float layer computes the same function
        y, _ = moe.forward(tp, _t(x), top_k=tcfg.top_k, kind=tcfg.act,
                           capacity_factor=0.0, precision="bf16")
        np.testing.assert_allclose(y.numpy(), got.numpy(), **TOL)


def test_moe_taps_follow_the_routed_rows(moe_layers):
    _jcfg, _jp, tcfg, tp = moe_layers["mla"]
    x = _t(_x((1, 4, 64), 6))
    taps: list = []
    moe.forward(tp, x, top_k=tcfg.top_k, capacity_factor=0.0,
                precision="bnn", taps=taps)
    names = [n for n, _ in taps]
    assert names == ["moe_in", "router_probs", "topk", "moe_down_in",
                     "gate", "up", "down"]
    probs, topk = taps[1][1], taps[2][1]
    assert probs.shape == (1, 4, tcfg.n_experts)
    assert topk.shape == (1, 4, tcfg.top_k)
    assert taps[3][1].shape == (1, 4, tcfg.top_k, tcfg.moe_d_ff)


def test_expert_stack_packs_once_per_stack():
    """The (E, K, N) stack packs once, keyed on the stack: every expert
    call hits the cache; an in-place write repacks."""
    rng = np.random.default_rng(7)
    w = _t(rng.standard_normal((4, 40, 24)).astype(np.float32))
    x = _t(rng.standard_normal((3, 40)).astype(np.float32))
    before = ops.packed_weight_cache_info()["entries"]
    outs = [ops.expert_dense(x, w, e, precision="bnn") for e in range(4)]
    assert ops.packed_weight_cache_info()["entries"] == before + 1
    for e, y in enumerate(outs):
        np.testing.assert_allclose(
            y.numpy(), ops.bnn_dense(x, w[e].clone(), precision="bnn").numpy(),
            rtol=1e-6, atol=1e-6)
    w[2].neg_()                   # a view's write moves the stack's version
    y = ops.expert_dense(x, w, 2, precision="bnn")
    np.testing.assert_array_equal(y.numpy(), -outs[2].numpy())
    np.testing.assert_allclose(
        ops.expert_dense(x, w, 1, precision="bf16").numpy(),
        (x @ w[1]).numpy(), rtol=1e-6, atol=1e-6)
