"""The stub front-ends over several ranks against the JAX package: the
reduced musicgen-large (audio: frame embeddings in place of tokens) and
pixtral-12b (vlm: patch embeddings before the tokens) at "bnn" on JAX's
weights, placed by the decode rules over (2, 2) and (1, 4) meshes of a
4-rank ``gloo`` world, the embeddings placed by batch.  ``logits_fn``
and the prefill step are within TOL of JAX's under the same ``Mesh`` (a
subprocess with 4 forced host devices), with its greedy tokens, and
bit-equal to the port's one rank."""
import numpy as np
import pytest
import torch

import _torch_ranks as H

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)     # float32 logits, port vs XLA
ARCHS = ["musicgen-large", "pixtral-12b"]
SHAPES = [(2, 2), (1, 4)]
IDS = ["2x2", "1x4"]
B, T = 4, 12


@pytest.fixture(scope="module")
def models():
    return {a: H.jax_models(a) for a in ARCHS}


@pytest.fixture(scope="module")
def batches(models):
    """Each arch's inputs (numpy): musicgen's frame embeddings, pixtral's
    patch embeddings (its prefix) and tokens."""
    out = {}
    for i, a in enumerate(ARCHS):
        jcfg = models[a][0]
        rng = np.random.default_rng(20 + i)
        emb = (rng.standard_normal((B, T, jcfg.d_model)) * 0.5) \
            .astype(np.float32)
        out[a] = ({"embeds": emb} if a == "musicgen-large" else
                  {"prefix_embeds": emb[:, :jcfg.frontend_prefix],
                   "tokens": rng.integers(0, jcfg.vocab, (B, T))
                   .astype(np.int32)})
    return out


@pytest.fixture(scope="module")
def jax_started(batches, tmp_path_factory):
    return {a: H.JaxMeshRun(a, batches[a], tmp_path_factory.mktemp(a),
                            SHAPES) for a in ARCHS}


@pytest.fixture(scope="module")
def ranks(jax_started, models, batches):
    cases = {a: (a, models[a][2], batches[a]) for a in ARCHS}
    return H.spawn(H.frontend_worker, 4, SHAPES, cases)


@pytest.fixture(scope="module")
def jax_mesh(jax_started, ranks):
    return {a: r.result() for a, r in jax_started.items()}


@pytest.fixture(scope="module")
def one_rank(models, batches):
    from repro_torch.launch import steps
    from repro_torch.models import transformer as M
    out = {}
    for a in ARCHS:
        cfg = H.port_cfg(arch=a)
        b = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
             for k, v in batches[a].items()}
        out[a] = (M.logits_fn(models[a][2], cfg, b.get("tokens"),
                              embeds=b.get("embeds"),
                              prefix_embeds=b.get("prefix_embeds")),
                  steps.build_prefill_step(cfg)(models[a][2], b))
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_logits_match_jax_mesh(ranks, jax_mesh, one_rank, arch,
                                        shape):
    want = jax_mesh[arch][shape]
    for rank in ranks:
        rec = rank[(shape, arch)]
        assert rec["placements"] == ["S(0)", "S(2)"]
        for got, jax_, one in ((rec["logits"], want["logits"],
                                one_rank[arch][0]),
                               (rec["prefill"], want["prefill"],
                                one_rank[arch][1])):
            assert torch.equal(got, one)
            np.testing.assert_allclose(got.numpy(), jax_, **TOL)
            np.testing.assert_array_equal(got.numpy().argmax(-1),
                                          jax_.argmax(-1))
