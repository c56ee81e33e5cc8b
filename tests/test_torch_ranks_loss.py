"""The training loss's vocab-parallel cross entropy over meshes of gloo
ranks (CPU): ``steps.value_and_grad`` of the reduced bnn-lm-100m at
"bnn_train" over (1, 4) and (2, 2) against one rank's on the same
weights and against the JAX package's ``loss_fn`` on one device, at the
bounds of the training tests over ranks (``_torch_ranks_train``): the
loss within ``LOSS_REL``, every gradient within ``GRAD_REL`` of its
largest element.  The head tied and untied; labels on both sides of
every rank's vocab boundary, label -1 rows and a chunk of -1 labels; a
loss chunk that divides the sequence and one that does not; remat on
and off.  Where ``model`` cuts the vocab the chunk runs
``_chunk_nll_cut`` on the rank's slice, the head is never gathered over
``model``, no float32 tensor of the loss has V columns, and where V/m
exceeds d_model the largest has V/m; a vocab ``model`` does not divide
keeps the whole-vocab chunk."""
import concurrent.futures

import numpy as np
import pytest
import torch

import _torch_ranks_train as H
from _torch_ranks import spawn
from _torch_train import assert_leaves_close, to_port, to_torch_batch
from repro_torch import tree as T
from repro_torch.interop import params_from_numpy
from repro_torch.launch import steps

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"
B, T_SEQ = 4, 24
CASES = [
    dict(key="tied-1x4", shape=(1, 4), tie=True, vocab=None, chunk=8,
         remat=False),
    dict(key="tied-1x4-remat-pad", shape=(1, 4), tie=True, vocab=None,
         chunk=10, remat=True),
    dict(key="tied-2x2", shape=(2, 2), tie=True, vocab=None, chunk=8,
         remat=False),
    dict(key="tied-2x2-remat-pad", shape=(2, 2), tie=True, vocab=None,
         chunk=10, remat=True),
    dict(key="untied-2x2-remat", shape=(2, 2), tie=False, vocab=None,
         chunk=8, remat=True),
    dict(key="untied-2x2-pad", shape=(2, 2), tie=False, vocab=None,
         chunk=10, remat=False),
    # a vocab whose slice is wider than d_model (64), so the logits are
    # the loss's largest tensor (at 128 the rows' copy at d is)
    dict(key="tied-1x4-v512-remat", shape=(1, 4), tie=True, vocab=512,
         chunk=8, remat=True),
    dict(key="untied-2x2-v512-pad", shape=(2, 2), tie=False, vocab=512,
         chunk=10, remat=False),
    # 130 = 2 x 5 x 13: "model" of 4 does not divide it, the cut dropped
    dict(key="whole-vocab-1x4", shape=(1, 4), tie=True, vocab=130,
         chunk=10, remat=True),
]


def _cfgs(case):
    from repro import configs as jconfigs
    from repro.configs.base import reduced as jreduced
    more = {"precision": "bnn_train", "tie_embeddings": case["tie"]}
    if case["vocab"]:
        more["vocab"] = case["vocab"]
    return (jreduced(jconfigs.get_config(ARCH)).replace(**more),
            H.port_cfg(ARCH).replace(**more))


def _batch(vocab: int, m: int) -> dict:
    """Tokens drawn from a seed; labels that sit on both sides of every
    boundary of ``m`` vocab slices (v0 - 1, v0, v0 + V/m - 1) in rows 0
    and 2, row 1 all -1, -1 here and there, and positions 16-23 all -1
    (a whole chunk of 8; with chunks of 10, the last chunk's labels are
    all -1 or padding)."""
    rng = np.random.default_rng(33)
    tokens = rng.integers(0, vocab, (B, T_SEQ)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, T_SEQ)).astype(np.int32)
    n = vocab // m
    edges = sorted({e for v0 in range(0, vocab, n)
                    for e in (v0 - 1, v0, v0 + n - 1) if 0 <= e < vocab})
    edges = (edges * 2)[:16]
    labels[0, :len(edges)] = edges
    labels[2, :len(edges)] = edges[::-1]
    labels[1] = -1
    labels[3, ::5] = -1
    labels[:, 16:] = -1
    return {"tokens": tokens, "labels": labels}


def _jax_value_and_grad(jcfg, jparams, batch, chunk):
    import jax
    from repro.models import transformer as JM
    (loss, met), g = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b, loss_chunk=chunk),
        has_aux=True))(jparams, batch)
    return float(loss), float(met["xent"]), g


@pytest.fixture(scope="module")
def runs():
    import jax
    from repro.models import transformer as JM
    params_of, batch_of, jax_of, np_batch = {}, {}, {}, {}
    for case in CASES:
        jcfg, tcfg = _cfgs(case)
        jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
        params_of[case["key"]] = (tcfg, params_from_numpy(
            jax.tree.map(np.asarray, jp), tcfg))
        np_batch[case["key"]] = _batch(tcfg.vocab, case["shape"][1])
        batch_of[case["key"]] = to_torch_batch(np_batch[case["key"]])
        jax_of[case["key"]] = (jcfg, jp)
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(spawn, H.loss_worker, 4, CASES, params_of, batch_of)
    ex.shutdown(wait=False)
    one, ref = {}, {}
    for case in CASES:
        key = case["key"]
        tcfg, params = params_of[key]
        loss, met, grads = steps.value_and_grad(
            params, tcfg, batch_of[key], loss_chunk=case["chunk"],
            remat=case["remat"])
        one[key] = {"loss": float(loss), "xent": float(met["xent"]),
                    "grads": grads}
        jcfg, jp = jax_of[key]
        jl, jx, jg = _jax_value_and_grad(jcfg, jp, np_batch[key],
                                         case["chunk"])
        ref[key] = {"loss": jl, "xent": jx, "grads": to_port(jg, tcfg)}
    return {"ranks": fut.result(), "one": one, "jax": ref,
            "cfg": {k: v[0] for k, v in params_of.items()}}


@pytest.mark.parametrize("key", [c["key"] for c in CASES])
def test_mesh_loss_and_grads_are_one_ranks_and_jaxs(runs, key):
    for r, rank in enumerate(runs["ranks"]):
        got = rank[key]
        for want, what in ((runs["one"][key], "one rank"),
                           (runs["jax"][key], "jax")):
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=H.LOSS_REL, err_msg=what)
            np.testing.assert_allclose(got["xent"], want["xent"],
                                       rtol=H.LOSS_REL, err_msg=what)
            assert_leaves_close(got["grads"], want["grads"], H.GRAD_REL,
                                f"{key} rank {r} vs {what}")
        for g in T.leaves(got["grads"]):
            assert g.abs().max() > 0, (key, r)


@pytest.mark.parametrize("key", [c["key"] for c in CASES])
def test_mesh_loss_keeps_the_vocab_cut(runs, key):
    """Over a mesh that cuts the vocab: only ``_chunk_nll_cut`` runs, no
    all-gather takes the head's shard over ``model`` (``spmd.full`` of
    the head does: the watch sees such a gather), and no float32 tensor
    of the loss has V columns; where V/m exceeds d_model (the chunk's
    rows, copied for the product, are (rows x chunk, d)) the largest is
    the chunk's (rows, chunk, V/m) logits.  A vocab that ``model`` does
    not divide: the whole-vocab chunk, its (rows, chunk, V) logits the
    largest."""
    case = next(c for c in CASES if c["key"] == key)
    cfg = runs["cfg"][key]
    vocab, m = cfg.vocab, case["shape"][1]
    cut = vocab % m == 0
    for rank in runs["ranks"]:
        got = rank[key]
        n_chunks = -(-T_SEQ // case["chunk"])
        name = "_chunk_nll_cut" if cut else "_chunk_nll"
        assert set(got["chunks"]) == {name}
        assert len(got["chunks"]) == n_chunks * (2 if case["remat"] else 1)
        assert got["loss_head_gathers"] == 0
        if cut:
            assert got["head_gathers"] > 0      # the watch sees spmd.full
        largest = max(got["shapes"], key=lambda s: int(np.prod(s)))
        cols = vocab // m if cut else vocab
        rows = B // case["shape"][0]
        if cols > cfg.d_model:
            # the product's (rows x chunk, cols), or its 3-d view
            assert largest[-1] == cols and \
                int(np.prod(largest)) == rows * case["chunk"] * cols, largest
        assert (rows, case["chunk"], cols) in got["shapes"]
        assert all(s[-1:] != (vocab,) for s in got["shapes"]) == cut
