"""The forward over several ranks against the JAX package: the reduced
bnn-lm-100m at "bnn" on JAX's weights, sharded by the decode rules over
(2, 2) and (1, 4) meshes of a 4-rank ``gloo`` world and a (1, 2) mesh
of a 2-rank one.

``logits_fn``'s logits are held to JAX's ``logits_fn`` under a 2x2
``Mesh`` of 4 forced host devices (a subprocess; its logits differ from
JAX's one device by ~1e-6) and to JAX's one device, within TOL (the
port's float32 against XLA's, as tests/test_torch_model.py), their
greedy tokens equal, and they come out placed as JAX's are (batch over
data, vocab over model).  The port's own one rank gives the same bits.
The serving steps: ``build_prefill_step``'s last-position logits and
``build_decode_step``'s tokens (the prompt a token a step, then greedy)
equal JAX's one-device steps'; the serve CLI's paged and legacy runs
over the mesh (``mesh=``) equal its one-device runs.  The collectives
a rank issues in the prefill step and in a warm decode step are the
dry-run's record of those steps for the same config, sizes and mesh
(``launch/dryrun.run_cell`` on ``meta`` shards under a fake group)."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as H
from repro.launch import steps as jsteps
from repro.models import transformer as JM
from repro_torch.configs.base import ShapeCell
from repro_torch.interop import params_from_numpy
from repro_torch.launch import collectives as coll, dryrun, serve as SV
from repro_torch.launch.mesh import fake_world
from repro_torch.models import transformer as M

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)     # float32 logits, port vs XLA
B, T, NEW = 4, 8, 6
MESHES = {(2, 2): 4, (1, 4): 4, (1, 2): 2}   # mesh -> world size
IDS = ["2x2", "1x4", "1x2"]


@pytest.fixture(scope="module")
def tokens(bnn_cfg):
    return np.random.default_rng(3).integers(0, bnn_cfg.vocab, (B, T)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def params(bnn_params):
    return params_from_numpy(jax.tree.map(np.asarray, bnn_params),
                             H.port_cfg())


@pytest.fixture(scope="module")
def ranks(params, tokens):
    """{mesh: every rank's forward_worker record}."""
    out = {}
    for size in (4, 2):
        shapes = [s for s, n in MESHES.items() if n == size]
        got = H.spawn(H.forward_worker, size, shapes, params, tokens, NEW)
        for s in shapes:
            out[s] = [g[s] for g in got]
    return out


@pytest.fixture(scope="module")
def jax_mesh(tokens, tmp_path_factory):
    return H.jax_mesh_logits(tokens, tmp_path_factory.mktemp("jax_mesh"))


@pytest.fixture(scope="module")
def jax_one(bnn_cfg, bnn_params, tokens):
    """JAX's one-device logits, prefill step and decode-step tokens."""
    logits = np.asarray(JM.logits_fn(bnn_params, bnn_cfg,
                                     {"tokens": jnp.asarray(tokens)}))
    pre = np.asarray(jax.jit(jsteps.build_prefill_step(bnn_cfg))(
        bnn_params, {"tokens": jnp.asarray(tokens)}))
    dec = jax.jit(jsteps.build_decode_step(bnn_cfg))
    caches = JM.init_cache(bnn_cfg, B, T + NEW)
    cur, seq = tokens[:, :1], [tokens[:, :1]]
    for i in range(T + NEW - 1):
        nxt, caches = dec(bnn_params, caches,
                          {"tokens": jnp.asarray(cur), "length": jnp.int32(i)})
        cur = tokens[:, i + 1:i + 2] if i + 1 < T else \
            np.asarray(nxt)[:, None]
        seq.append(cur)
    return {"logits": logits, "prefill": pre,
            "decode": np.concatenate(seq, axis=1)}


def test_jax_mesh_run_is_the_one_device_run(jax_mesh, jax_one):
    logits, spec = jax_mesh
    assert spec == ("data", None, "model")
    np.testing.assert_allclose(logits, jax_one["logits"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", list(MESHES), ids=IDS)
def test_logits_match_jax_mesh_and_one_device(ranks, jax_mesh, jax_one,
                                              params, tokens, shape):
    one_rank = M.logits_fn(params, H.port_cfg(),
                           torch.from_numpy(tokens.astype(np.int64)))
    for rec in ranks[shape]:
        got = rec["logits"].numpy()
        # batch over data (when it divides: it does at B = 4), vocab
        # over model: JAX's PartitionSpec("data", None, "model")
        assert rec["placements"] == ["S(0)", "S(2)"]
        assert torch.equal(rec["logits"], one_rank)
        np.testing.assert_allclose(got, jax_mesh[0], **TOL)
        np.testing.assert_allclose(got, jax_one["logits"], **TOL)
        np.testing.assert_array_equal(got.argmax(-1),
                                      jax_one["logits"].argmax(-1))


@pytest.mark.parametrize("shape", list(MESHES), ids=IDS)
def test_head_is_each_ranks_vocab_slice_on_its_rows(ranks, bnn_cfg, shape):
    """The LM head runs as each rank's vocab slice of the tied head on
    its own rows: a rank's logits are (B / data, T, V / model), placed
    batch over ``data`` and vocab over ``model``; no rank caches a whole
    head (no cache kind of it, no cached value as large as it), and
    what a rank caches beside its slices is ``rank_weight_bytes``'
    "cached", nothing for this dense config."""
    from repro_torch.launch.mesh import rank_weight_bytes
    d, m = shape
    head_bytes = bnn_cfg.d_model * bnn_cfg.vocab * 4
    want = rank_weight_bytes(H.port_cfg(), shape)["cached"]
    assert want == 0
    for rec in ranks[shape]:
        assert rec["placements"] == ["S(0)", "S(2)"]
        assert rec["logits_local"] == (B // d, T, bnn_cfg.vocab // m)
        assert "whole_head" not in rec["cache_kinds"]
        assert rec["largest_cached"] < head_bytes
        assert rec["cached_bytes"] == want


@pytest.mark.parametrize("shape", list(MESHES), ids=IDS)
def test_serving_steps_give_jax_tokens(ranks, jax_one, shape):
    for rec in ranks[shape]:
        np.testing.assert_allclose(rec["prefill"].numpy(), jax_one["prefill"],
                                   **TOL)
        np.testing.assert_array_equal(rec["prefill"].numpy().argmax(-1),
                                      jax_one["prefill"].argmax(-1))
        np.testing.assert_array_equal(rec["decode"].numpy(),
                                      jax_one["decode"])


@pytest.mark.parametrize("shape", list(MESHES), ids=IDS)
def test_serve_cli_over_a_mesh_equals_one_device(ranks, jax_one, params,
                                                 tokens, shape):
    want = SV.serve(H.ARCH, smoke=True, precision="bnn", gen=NEW,
                    device="cpu", params=params, prompts=tokens,
                    verbose=False)
    np.testing.assert_array_equal(want, jax_one["decode"])
    for rec in ranks[shape]:
        for engine in ("paged", "legacy"):
            np.testing.assert_array_equal(rec["serve"][engine], want)


@pytest.mark.parametrize("shape", list(MESHES), ids=IDS)
def test_serving_steps_collectives_are_the_dry_runs(ranks, shape):
    """The prefill step's and the second decode step's collectives on
    every rank: calls and bytes sent by kind, and JAX's result bytes,
    as the dry-run records them (its steady step: a rank's per-weight
    caches were filled by ``logits_fn`` before)."""
    cfg = H.port_cfg()
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    cells = {"prefill": ShapeCell("prefill", T, B, "prefill"),
             "decode": ShapeCell("decode", T + NEW, B, "decode")}
    with fake_world(MESHES[shape]):
        m = H.mesh(shape)
        recs = {k: dryrun.run_cell(H.ARCH, c, False, mesh=m, overrides=over,
                                   dtype=torch.float32)
                for k, c in cells.items()}
    for kind, rec in recs.items():
        assert rec["status"] == "ok" and rec["memory"]["temp_size_in_bytes"]
        for r in ranks[shape]:
            sent, result = collections.Counter(), collections.Counter()
            for k, group, nbytes, tags in r["events"][kind]:
                assert ("first_use", True) not in tags
                sent[k] += 1
                sent[k + "_bytes"] += nbytes
                result[coll.JAX_KIND[k]] += coll.result_bytes(k, group,
                                                              nbytes)
            assert sent and rec["sent"] == dict(sent), kind
            assert {k: rec["collectives"][k]["bytes_executed"]
                    for k in coll.KINDS if result[k]} == dict(result)
