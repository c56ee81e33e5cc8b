"""The fallbacks of the forward over several ranks, on real ``gloo``
ranks: where a head count does not divide the model axis (the
head_dim fallback), where the experts do not (the ``mlp`` cut of each
expert), and a row-parallel GEMM whose K slice is not a whole number
of 32-bit words.

* Reduced mixtral-8x7b and llama3.2-3b (4 heads, 1 kv head each) on
  JAX's weights over (1, 2) and (1, 4): k and v are cut inside the kv
  head, as JAX places them; the port gathers them to whole heads before
  RoPE and holds the kv head whole on every model rank, in the pools
  too.  ``logits_fn`` is within TOL of JAX's under the same ``Mesh``
  (a subprocess with 4 forced host devices), with its greedy tokens,
  and, as a one-chunk ``prefill_chunk``, bit-equal to the port's one
  rank.
* 6 heads and 6 kv heads on a 4-way axis (q too is cut inside heads),
  and 6 experts on a 4-way axis (each expert's hidden cut in 4, the
  down projection's partial dots summed before alpha, at half-word K
  slices): bit-equal to one rank, full sequence and prefill.
* K = 80 over 2 ranks (40 = 1.25 words a rank): bit-equal to one rank.
* SSM layers and the jamba hybrid build over a mesh (ROADMAP.md queue
  1, item 11a, done); the serve CLI's production mesh places mixtral,
  deepseek-v2-lite, mamba2 and jamba as the decode rules say."""
import numpy as np
import pytest
import torch

import _torch_ranks as H
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as MESH, serve as SV
from repro_torch.layers import attn_block
from repro_torch.models import transformer as M
from repro_torch.serving import Engine, EngineConfig

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)     # float32 logits, port vs XLA
ARCHS = ["mixtral-8x7b", "llama3.2-3b"]
SHAPES = [(1, 2), (1, 4)]
IDS = ["1x2", "1x4"]
B, T = 2, 12


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(5).integers(0, 128, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_started(tokens, tmp_path_factory):
    return {a: H.JaxMeshRun(a, tokens, tmp_path_factory.mktemp(a), SHAPES)
            for a in ARCHS}


@pytest.fixture(scope="module")
def models():
    return {a: H.jax_models(a) for a in ARCHS}


def _own(cfg):
    return cfg, M.init(torch.Generator().manual_seed(0), cfg)


@pytest.fixture(scope="module")
def own():
    """Configs on the port's own seeded weights: 6 heads on a 4-way
    axis, 6 experts on a 4-way axis."""
    return {"heads6": _own(H.port_cfg().replace(n_heads=6, n_kv_heads=6)),
            "experts6": _own(H.port_cfg(arch="mixtral-8x7b").replace(
                n_experts=6))}


@pytest.fixture(scope="module")
def gemm80():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 80)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((80, 24)).astype(np.float32))
    return x, {"w": w}, {"w": ("mlp", "embed")}


@pytest.fixture(scope="module")
def ranks(jax_started, models, own, tokens, gemm80):
    tok = torch.from_numpy(tokens.astype(np.int64))
    cases = {a: (H.port_cfg(arch=a), models[a][2], tok) for a in ARCHS}
    out = {(1, 2): H.spawn(H.cases_worker, 2, (1, 2), cases,
                           {"k80": gemm80})}
    cases.update({k: (cfg, p, tok) for k, (cfg, p) in own.items()})
    out[(1, 4)] = H.spawn(H.cases_worker, 4, (1, 4), cases, {})
    return out


@pytest.fixture(scope="module")
def jax_mesh(jax_started, ranks):
    return {a: r.result() for a, r in jax_started.items()}


@pytest.fixture(scope="module")
def one_rank(models, own, tokens):
    tok = torch.from_numpy(tokens.astype(np.int64))
    cases = {a: (H.port_cfg(arch=a), models[a][2]) for a in ARCHS}
    cases.update(own)
    return {k: (M.logits_fn(p, cfg, tok), H.prefill_logits(p, cfg, tok))
            for k, (cfg, p) in cases.items()}


def test_check_heads_is_gone():
    assert not hasattr(attn_block, "_check_heads")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_head_dim_fallback_gives_jax_logits(ranks, jax_mesh, models, one_rank,
                                            shape, arch):
    want = jax_mesh[arch][shape]
    assert want["params"]["layers/0/attn/k/w"] == (None, "model")
    assert H.port_placements(arch, models[arch][2], shape) == \
        want["params"]
    for rank in ranks[shape]:
        rec = rank[arch]
        got = rec["logits"].numpy()
        np.testing.assert_allclose(got, want["logits"], **TOL)
        np.testing.assert_array_equal(got.argmax(-1),
                                      want["logits"].argmax(-1))
        assert torch.equal(rec["logits"], one_rank[arch][0])
        assert torch.equal(rec["prefill"], one_rank[arch][1])
        # the one kv head whole on every rank, its pools too
        assert all(p == {"k": (None,) * 4, "v": (None,) * 4}
                   for p in rec["pools"])


@pytest.mark.parametrize("case", ["heads6", "experts6"])
def test_non_dividing_heads_and_experts_equal_one_rank(ranks, one_rank, own,
                                                       case):
    cfg, params = own[case]
    with MESH.fake_world(4):
        tp = S.place_params(params, cfg, H.mesh((1, 4)))
        lp = tp["layers"][0]
        if case == "heads6":      # 96 columns cut in 4: 1.5 heads a rank
            assert H.port_spec(lp["attn"]["q"]["w"]) == (None, "model")
        else:                     # 6 experts on 4 ranks: the hidden cut
            assert H.port_spec(lp["ffn"]["up"]) == (None, None, "model")
            assert H.port_spec(lp["ffn"]["down"]) == (None, "model", None)
    for rank in ranks[(1, 4)]:
        assert torch.equal(rank[case]["logits"], one_rank[case][0])
        assert torch.equal(rank[case]["prefill"], one_rank[case][1])


def test_row_parallel_gemm_on_part_words_equals_one_rank(ranks, gemm80):
    from repro_torch.kernels import ops
    x, w, _axes = gemm80
    want = ops.bnn_dense(x, w["w"], precision="bnn", impl="torch")
    for rank in ranks[(1, 2)]:
        assert rank["k80"]["spec"] == ("model", None)
        assert torch.equal(rank["k80"]["out"], want)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_ssm_and_hybrid_over_a_mesh_raise_item_11a(arch):
    """Item 11a is done: SSM layers and the jamba hybrid no longer raise
    over a mesh.  The engine builds, its slot pools (the snapshot rows
    too) hold ``h`` by heads and the conv tail whole, and the paged
    pools place alike (tests/test_torch_ranks_ssm.py and
    tests/test_torch_ranks_hybrid.py run them)."""
    cfg = H.port_cfg(arch=arch)
    params = M.init(torch.Generator().manual_seed(0), cfg)
    slot = {"h": (None, "model", None, None), "conv": (None,) * 3}
    with MESH.fake_world(2):
        m = H.mesh((1, 2))
        eng = Engine(params, cfg, EngineConfig(**H.EKW), device="cpu",
                     mesh=m)
        ssm = eng.cache.ssm
        for pools in (ssm.pools, ssm.snapshots.pools):
            assert all({k: H.port_spec(v) for k, v in p.items()} == slot
                       for p in pools)
        pools = M.init_paged_state(cfg, 8, 4, 4, mesh=m)
        assert [{k: H.port_spec(v) for k, v in p.items()} == slot
                for p in pools] == [mix == "ssm"
                                    for mix, _f in M.layer_plan(cfg)]
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b"])
def test_serve_setup_places_the_families_on_the_production_mesh(arch):
    """Under a 256-rank group a non-smoke serve builds the (16, 16) mesh
    and places the reduced config's params by the decode rules (4
    experts do not divide 16: each expert's hidden is cut instead; the
    SSM layers' in_proj by columns)."""
    cfg = H.port_cfg(arch=arch)
    with MESH.fake_world(256):
        m = SV.serving_mesh(device="cpu")
        got_cfg, params = SV.setup(arch, smoke=True, precision="bnn",
                                   device="cpu", mesh=m)
        assert got_cfg == cfg
        specs = M.param_specs(cfg)
        want = S.param_shardings(m, M.trainable(params, cfg), specs,
                                 S.rules_decode(False))
        got = S.map_specs(lambda a, t: list(t.placements), specs,
                          M.trainable(params, cfg))
        assert got == want
        if cfg.n_experts:
            moe = params["layers"][-1]["ffn"]
            assert H.port_spec(moe["up"]) == (None, None, "model")
        if cfg.ssm_state:
            assert H.port_spec(params["layers"][0]["attn"]["in_proj"]["w"]) \
                == (None, "model")
    assert not torch.distributed.is_initialized()
