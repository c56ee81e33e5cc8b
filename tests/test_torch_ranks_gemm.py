"""The tensor-parallel BNN GEMMs over real ``gloo`` ranks on the CPU,
the refusals of the forward over several ranks (and what no longer
refuses), the sharding context, and the serve CLI's production mesh.

Every projection of layer 0 of the reduced bnn-lm-100m (q, k, v and
gate, up column-parallel; o and down row-parallel), its weight placed
by the decode rules and its input rows sharded over ``data``, on a
(2, 2) and a (1, 4) mesh of one 4-rank world: at "bnn" bit-equal to
one rank's plain version (the (1, 4) mesh cuts o's K = 64 into
half-word slices of 16), at "bf16" within BF16_TOL (float32 sums taken
in another order: the row-parallel partial sums are added across the
ranks); a second pass packs no weight again."""
import numpy as np
import pytest
import torch

import _torch_ranks as H
from repro_torch.dist import sharding as S, spmd
from repro_torch.kernels import ops
from repro_torch.launch import mesh as MESH, serve as SV
from repro_torch.layers import common as C
from repro_torch.models import transformer as M
from repro_torch.serving import Engine, EngineConfig

torch.set_num_threads(1)

SHAPES = [(2, 2), (1, 4)]
NAMES = ("q", "k", "v", "o", "gate", "up", "down")
ROWS = 4
# |TP - one rank| at "bf16": inputs N(0, 1), weights N(0, 1/K), K <= 128,
# outputs O(1); float32 sums of <= 128 terms in another order
BF16_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def layer():
    cfg = H.port_cfg()
    p = M.init(torch.Generator().manual_seed(0), cfg)["layers"][0]
    return {**p["attn"], **p["ffn"]}


@pytest.fixture(scope="module")
def xs():
    rng = np.random.default_rng(7)
    return {k: torch.from_numpy(rng.standard_normal((ROWS, k))
                                .astype(np.float32)) for k in (64, 128)}


@pytest.fixture(scope="module")
def ranks(layer, xs):
    return H.spawn(H.gemm_worker, 4, SHAPES, layer, xs)


def _want(layer, xs, prec, name):
    w = layer[name]["w"]
    return ops.bnn_dense(xs[w.shape[0]], w, precision=prec, impl="torch")


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("name", NAMES)
def test_tp_gemm_equals_one_rank(ranks, layer, xs, shape, name):
    col = name not in ("o", "down")
    for rank in ranks:
        got = rank[shape]["out"]
        assert got[("placements", name)] == \
            (["R", "S(1)"] if col else ["R", "S(0)"])
        assert torch.equal(got[("bnn", name)], _want(layer, xs, "bnn", name))
        np.testing.assert_allclose(got[("bf16", name)].numpy(),
                                   _want(layer, xs, "bf16", name).numpy(),
                                   **BF16_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_weights_pack_once(ranks, shape):
    """The first pass packs each weight once (its shard's words and
    alpha, under the DTensor weight); the second repacks nothing.  Each
    placed weight gathers back (``gather_tree``) to itself."""
    for rank in ranks:
        assert rank[shape]["packs"] == [len(NAMES), 0]
        assert rank[shape]["round_trip"]


# ------------------------------------------------------------- refusals


def test_lsc_outside_a_context_is_the_identity():
    x = torch.randn(2, 3, 4)
    assert C.lsc(x, "batch", None, "mlp") is x
    assert spmd.full(x) is x and spmd.rows(x, x) is x


def test_sharding_context_restores_the_enclosing_one():
    with MESH.fake_world(4):
        outer, inner = H.mesh((2, 2)), H.mesh((1, 4))
        r = S.rules_decode(False)
        with C.sharding_context(outer, r):
            with C.sharding_context(inner, r):
                assert C._CTX.mesh is inner
            assert C._CTX.mesh is outer
            y = C.lsc(torch.zeros(4, 3), "batch", None)
            assert [str(p) for p in y.placements] == ["S(0)", "R"]
        assert C._CTX.mesh is None
    assert not torch.distributed.is_initialized()


def test_non_dividing_head_count_raises_item_11():
    """6 heads on a 4-way model axis: q's 96 columns divide, its heads
    do not.  The head_dim fallback (ROADMAP.md queue 1, item 11, done)
    runs it: q stays cut inside its heads, as JAX places it, and the
    forward gathers whole heads instead of raising (its values are held
    to one rank's on real ranks in tests/test_torch_ranks_heads.py)."""
    cfg = H.port_cfg().replace(n_heads=6, n_kv_heads=6)
    params = M.init(torch.Generator().manual_seed(0), cfg)
    with MESH.fake_world(4):
        m = H.mesh((1, 4))
        tp = S.place_params(params, cfg, m)
        assert spmd.shards(tp["layers"][0]["attn"]["q"]["w"], 1) == 4
        with C.sharding_context(m, S.rules_decode(False)):
            lg = M.logits_fn(tp, cfg, torch.zeros(1, 4, dtype=torch.long))
        assert lg.shape == (1, 4, cfg.vocab)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b",
                                  "mamba2-1.3b"])
def test_other_families_under_a_mesh_raise_item_11(arch):
    """None of them raises now (ROADMAP.md queue 1, item 11a, done):
    the engine builds over a mesh, its pools placed whole on every model
    rank (mixtral's one kv head, deepseek's latents) or, for mamba2's
    slots, ``h`` by heads and the conv tail whole."""
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    cfg = reduced(configs.get_config(arch)).replace(precision="bnn")
    params = M.init(torch.Generator().manual_seed(0), cfg)
    with MESH.fake_world(2):
        m = H.mesh((1, 2))
        eng = Engine(params, cfg, EngineConfig(**H.EKW), device="cpu",
                     mesh=m)
        for pool in eng.cache.pools:
            assert all(H.port_spec(v) == ((None, "model", None, None)
                                          if k == "h" else (None,) * v.ndim)
                       for k, v in pool.items())
    assert not torch.distributed.is_initialized()


def test_serve_setup_builds_the_production_mesh():
    """Under a 256-rank group a non-smoke serve builds the (16, 16)
    ("data", "model") mesh and places the params by the decode rules
    (the reduced config's here: the full width is not drawn on the
    CPU); a 512-rank mesh needs 512 ranks."""
    cfg = H.port_cfg()
    with MESH.fake_world(256):
        m = SV.serving_mesh(device="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.shape == (16, 16)
        with pytest.raises(ValueError, match="512"):
            SV.serving_mesh(multi_pod=True, device="cpu")
        got_cfg, params = SV.setup(H.ARCH, smoke=True, precision="bnn",
                                   device="cpu", mesh=m)
        assert got_cfg == cfg
        specs = M.param_specs(cfg)
        want = S.param_shardings(m, M.trainable(params, cfg), specs,
                                 S.rules_decode(False))
        got = S.map_specs(lambda a, t: list(t.placements), specs,
                          M.trainable(params, cfg))
        assert got == want
        assert [str(p) for p in params["head"]["w"].placements] == \
            ["R", "S(1)"]
        assert SV.serving_mesh(smoke=True, device="cpu") is None
    assert SV.serving_mesh(device="cpu") is None
    assert not torch.distributed.is_initialized()
