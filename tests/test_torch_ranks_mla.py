"""The MLA family over several ranks against the JAX package: the
reduced deepseek-v2-lite (MLA over paged latents, a dense first layer,
4 experts top-2 and 2 shared experts) at "bnn" on JAX's weights,
placed by the decode rules over meshes of a 4-rank ``gloo`` world.

Every leaf's placement equals JAX's ``PartitionSpec`` over (1, 2),
(2, 2) and (1, 4): q by heads, kv_down replicated, k_up and v_up by
latent rows (``kv_lora`` wins the dedup), the expert stacks by whole
experts, the shared experts and the dense layer by ``mlp``.  ``logits_fn`` over (2, 2) and (1, 4) is within TOL of
JAX's ``logits_fn`` under the same ``Mesh`` (a subprocess with 4
forced host devices), with its greedy tokens, and bit-equal to the
port's one rank dispatching in as many groups as the mesh has data
ranks: the auto dispatch groups follow the data degree, and over
(2, 2) that changes the logits beyond TOL, in both packages.  The
serving steps give JAX's tokens, and the engine over both meshes gives
one JAX ``Engine``'s and the port's one rank's tokens, greedy and
sampled, with its latent pool swapping."""
import numpy as np
import pytest
import torch

import _torch_ranks as H

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-4)     # float32 logits, port vs XLA
B, T, NEW = 4, 12, 6
SHAPES = [(2, 2), (1, 4)]
PLACED = [(1, 2), (2, 2), (1, 4)]
IDS = ["2x2", "1x4"]
# 12 blocks of 4 tokens under 4 decode rows of up to 20 tokens each:
# preemptions, swapped out (tests/test_torch_ranks_engine.py's schedule)
LENS = [5, 9, 3, 7, 12, 4, 8, 6]
MAX_NEW = 8
EKW = dict(num_blocks=13)


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
                        PLACED, SHAPES)


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
def ranks(jax_mesh_started, models, tokens, prompts):
    return H.spawn(H.family_worker, 4, ARCH, SHAPES, models[2], tokens, NEW,
                   prompts, MAX_NEW, EKW)


@pytest.fixture(scope="module")
def engines(models, prompts):
    """(JAX's tokens, the port's one-rank (tokens, stats)), greedy then
    sampled."""
    jcfg, jp, params = models
    return (H.jax_engine_tokens(jcfg, jp, prompts, MAX_NEW, EKW),
            [H.serve(params, H.port_cfg(arch=ARCH), prompts, MAX_NEW,
                     sampled=s, **EKW) for s in (False, True)])


@pytest.mark.parametrize("shape", PLACED, ids=["1x2", "2x2", "1x4"])
def test_placements_equal_jax(models, jax_mesh, shape):
    got = H.port_placements(ARCH, models[2], shape)
    want = jax_mesh[shape]["params"]
    assert got == want
    assert got["layers/1/ffn/up"] == ("model", None, None)
    assert got["layers/1/ffn/shared/up/w"] == (None, "model")
    assert got["layers/0/ffn/up/w"] == (None, "model")
    assert got["layers/0/attn/q/w"] == (None, "model")
    assert got["layers/0/attn/kv_down/w"] == (None, None)
    assert got["layers/0/attn/k_up/w"] == ("model", None)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_logits_and_steps_match_jax_mesh(ranks, jax_mesh, jax_one, one_rank,
                                         shape):
    H.check_family(ranks, shape, jax_mesh=jax_mesh, jax_one=jax_one,
                   one_rank=one_rank, tol=TOL)


def test_auto_dispatch_groups_follow_the_data_degree(jax_mesh, jax_one,
                                                     one_rank):
    """Two data ranks dispatch in two groups, which drop other tokens
    than one group does: in JAX and in the port alike."""
    for a, b in ((jax_mesh[(2, 2)]["logits"], jax_one["logits"]),
                 (one_rank[2].numpy(), one_rank[1].numpy())):
        assert not np.allclose(a, b, **TOL)
    np.testing.assert_allclose(jax_mesh[(1, 4)]["logits"], jax_one["logits"],
                               **TOL)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_engine_over_ranks_gives_jax_tokens(ranks, engines, shape, sampled):
    jax_tokens, one = engines
    want = jax_tokens[sampled]
    assert one[sampled][0] == want
    for rank in ranks:
        run = rank["engine"][shape][sampled]
        assert run["tokens"] == want
        assert run["preemptions"] == one[sampled][1]["preemptions"]
        assert run["swap_outs"] == one[sampled][1]["swap"]["swap_outs"]


def test_the_schedule_swaps(engines, ranks):
    for _toks, st in engines[1]:
        assert st["swap"]["swap_outs"] > 0
    assert all(run["swap_outs"] > 0 for rank in ranks
               for runs in rank["engine"].values() for run in runs)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_cached_bytes_as_reckoned(ranks, shape):
    """What every rank caches at first use beside its slices (the whole
    LM head, MLA's k_up/v_up columns of the rank's heads) is what
    ``rank_weight_bytes`` reckons."""
    from repro_torch.launch.mesh import rank_weight_bytes
    want = rank_weight_bytes(H.port_cfg(arch=ARCH), shape)["cached"]
    assert want > 0
    assert [r["forward"][shape]["cached_bytes"] for r in ranks] == \
        [want] * len(ranks)
