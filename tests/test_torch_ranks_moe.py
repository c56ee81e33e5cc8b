"""The MoE family over several ranks against the JAX package: the
reduced mixtral-8x7b (GQA over a sliding-window ring, 4 experts top-2)
at "bnn" on JAX's weights, placed by the decode rules over meshes of a
4-rank ``gloo`` world.

Every leaf's placement equals JAX's ``PartitionSpec`` over (1, 2),
(2, 2) and (1, 4): the expert stacks by whole experts over ``model``,
the router replicated, k and v cut inside the one kv head (head_dim
over ``model``).  ``logits_fn`` over (2, 2) and (1, 4) is within TOL of
JAX's ``logits_fn`` under the same ``Mesh`` (a subprocess with 4
forced host devices), with its greedy tokens, and bit-equal to the
port's one rank dispatching in as many groups as the mesh has data
ranks: the auto dispatch groups follow the data degree, and over
(2, 2) that changes the logits beyond TOL, in both packages.  The
serving steps give JAX's tokens (the legacy decode's ring wraps), and
the engine over both meshes gives one JAX ``Engine``'s and the port's
one rank's tokens, greedy and sampled, with its pool swapping and its
rings wrapping."""
import numpy as np
import pytest
import torch

import _torch_ranks as H

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"
TOL = dict(rtol=1e-4, atol=1e-4)     # float32 logits, port vs XLA
B, T, NEW = 4, 36, 6                 # 42 > the 32-token window
SHAPES = [(2, 2), (1, 4)]
PLACED = [(1, 2), (2, 2), (1, 4)]
IDS = ["2x2", "1x4"]
# 8 requests, three longer than the window; rings of 10 blocks of 4
# under 4 decode rows in a pool of 21: preemptions, swapped out
LENS = [30, 9, 45, 12, 40, 22, 7, 52]
MAX_NEW = 8
EKW = dict(num_blocks=22, prefill_chunk=8, max_model_len=96)


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
    assert got["layers/0/ffn/up"] == ("model", None, None)
    assert got["layers/0/ffn/router/w"] == (None, None)
    assert got["layers/0/attn/k/w"] == (None, "model")


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


def test_the_schedule_swaps_and_the_rings_wrap(engines, ranks):
    for _toks, st in engines[1]:
        assert st["swap"]["swap_outs"] > 0
        assert st["mixer"]["blocks"]["ring_reuses"] > 0
    assert all(run["ring_reuses"] > 0 for rank in ranks
               for runs in rank["engine"].values() for run in runs)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_cached_bytes_as_reckoned(ranks, shape):
    """What every rank caches at first use beside its slices is what
    ``rank_weight_bytes`` reckons: nothing for mixtral (the LM head is
    the rank's vocab slice, no whole head is cached)."""
    from repro_torch.launch.mesh import rank_weight_bytes
    want = rank_weight_bytes(H.port_cfg(arch=ARCH), shape)["cached"]
    assert want == 0
    assert [r["forward"][shape]["cached_bytes"] for r in ranks] == \
        [want] * len(ranks)
