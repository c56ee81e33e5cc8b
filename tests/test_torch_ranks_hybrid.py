"""The jamba hybrid over several ranks against the JAX package: the
reduced jamba-1.5-large (a period of 8 layers: SSD layers over
recurrent slots, one GQA layer over paged blocks with its one kv head,
MoE every second layer, a dense FFN on the others) at "bnn" on JAX's
weights, placed by the decode rules over meshes of ``gloo`` ranks (a
world of 2 and one of 4).

Every leaf's placement equals JAX's ``PartitionSpec`` over (1, 2),
(2, 2) and (1, 4); the pools hold the GQA layer's one kv head whole
(the head_dim fallback) and each SSM layer's ``h`` by heads.
``logits_fn`` and the prefill step are within TOL of JAX's under the
same ``Mesh`` (a subprocess with 4 forced host devices), with its
greedy tokens, and bit-equal to the port's one rank dispatching in as
many groups as the mesh has data ranks; the legacy decode gives JAX's
one device's tokens.  The engine over each mesh gives one JAX
``Engine``'s tokens, greedy and sampled, with 3 slots and 12 blocks
under 4 decode rows.  The slots under the JAX engine's defaults and
``init_on_ranks``: tests/test_torch_ranks_hybrid_slots.py."""
import numpy as np
import pytest
import torch

import _torch_ranks as H

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-4, atol=1e-4)     # float32 logits, port vs XLA
B, T, NEW = 4, 12, 6
SHAPES = [(1, 2), (2, 2), (1, 4)]
IDS = ["1x2", "2x2", "1x4"]
LENS = [5, 9, 3, 7, 12, 4, 8, 6]
MAX_NEW = 8
# 3 slots under 4 decode rows, 12 blocks of 4 tokens
EKW = dict(num_slots=4, num_blocks=13)


@pytest.fixture(scope="module")
def models():
    return H.jax_models(ARCH)


@pytest.fixture(scope="module")
def tokens(models):
    return np.random.default_rng(3).integers(0, models[0].vocab, (B, T)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def prompts(models):
    return H.prompts(models[0].vocab, LENS, seed=12)


@pytest.fixture(scope="module")
def jax_mesh_started(tokens, tmp_path_factory):
    return H.JaxMeshRun(ARCH, tokens, tmp_path_factory.mktemp("jax_mesh"),
                        SHAPES)


@pytest.fixture(scope="module")
def jax_mesh(jax_mesh_started, ranks):
    """JAX's mesh runs (started before the ranks, run beside them)."""
    return jax_mesh_started.result()


@pytest.fixture(scope="module")
def jax_one(models, tokens):
    jcfg, jp, _ = models
    return H.jax_one_device(ARCH, jcfg, jp, tokens, NEW)


@pytest.fixture(scope="module")
def one_rank(models, tokens):
    """The port's one-rank logits by dispatch groups."""
    from repro_torch.models import transformer as M
    cfg, tok = H.port_cfg(arch=ARCH), torch.from_numpy(tokens.astype(np.int64))
    return {g: M.logits_fn(models[2], cfg.replace(moe_dispatch_groups=g), tok)
            for g in (1, 2)}


@pytest.fixture(scope="module")
def ranks_started(jax_mesh_started, models, tokens, prompts):
    return H.spawn_worlds(
        H.family_worker, ((2, [(1, 2)]), (4, [(2, 2), (1, 4)])),
        lambda shapes: (ARCH, shapes, models[2], tokens, NEW, prompts,
                        MAX_NEW, EKW))


@pytest.fixture(scope="module")
def ranks(ranks_started, jax_one, one_rank, engines):
    """Per world size, each rank's family runs (the references built
    while they ran)."""
    return ranks_started.result(timeout=600)


def _ranks(ranks, shape):
    return ranks[shape[0] * shape[1]]


@pytest.fixture(scope="module")
def engines(models, prompts):
    """(JAX's tokens, the port's one-rank (tokens, stats)), greedy then
    sampled."""
    jcfg, jp, params = models
    return (H.jax_engine_tokens(jcfg, jp, prompts, MAX_NEW, EKW),
            [H.serve(params, H.port_cfg(arch=ARCH), prompts, MAX_NEW,
                     sampled=s, **EKW) for s in (False, True)])


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_placements_equal_jax(models, jax_mesh, shape):
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import transformer as M
    got = H.port_placements(ARCH, models[2], shape)
    assert got == jax_mesh[shape]["params"]
    assert got["layers/0/attn/in_proj/w"] == (None, "model")
    assert got["layers/0/attn/out_proj/w"] == ("model", None)
    assert got["layers/3/attn/k/w"] == (None, "model")   # inside the head
    assert got["layers/3/ffn/up"] == ("model", None, None)
    cfg = H.port_cfg(arch=ARCH)
    with MESH.fake_world(shape[0] * shape[1]):
        pools = M.init_paged_state(cfg, 8, 4, 5, mesh=H.mesh(shape))
        for mix, p in zip(M.layer_plan(cfg), pools):
            got = {k: H.port_spec(v) for k, v in p.items()}
            assert got == ({"k": (None,) * 4, "v": (None,) * 4}
                           if mix[0] == "gqa" else
                           {"h": (None, "model", None, None),
                            "conv": (None,) * 3})


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_logits_and_steps_match_jax_mesh(ranks, jax_mesh, jax_one, one_rank,
                                         shape):
    H.check_family(_ranks(ranks, shape), shape, jax_mesh=jax_mesh,
                   jax_one=jax_one, one_rank=one_rank, tol=TOL)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_engine_over_ranks_gives_jax_tokens(ranks, engines, shape, sampled):
    jax_tokens, one = engines
    want = jax_tokens[sampled]
    assert one[sampled][0] == want
    for rank in _ranks(ranks, shape):
        run = rank["engine"][shape][sampled]
        assert run["tokens"] == want
        assert run["preemptions"] == one[sampled][1]["preemptions"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_cached_bytes_as_reckoned(ranks, shape):
    from repro_torch.launch.mesh import rank_weight_bytes
    want = rank_weight_bytes(H.port_cfg(arch=ARCH), shape)["cached"]
    assert [r["forward"][shape]["cached_bytes"]
            for r in _ranks(ranks, shape)] == \
        [want] * shape[0] * shape[1]

