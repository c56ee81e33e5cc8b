"""Training over several ranks: the reduced bnn-lm-100m at "bnn_train"
trained by ``launch.train`` over (2, 2) and (1, 4) meshes of gloo ranks
(FSDP: the params placed by the train rules, gathered over ``data`` a
layer at a time), with 1 and 2 microbatches, against the JAX package's
``build_train_step`` on the same mesh (4 forced host devices, a
subprocess started beside the ranks): every leaf's placement, step 0's
loss, every gradient and the gradient norm, each step's loss, norm and
learning rate, and the params after 3 steps, within the one-rank
training tests' bounds; one step at "bf16" over (2, 2).  Also: a leaf
without a gradient raises over a mesh (one rank gives it zeros, as
JAX's gradient of an unused leaf); a checkpoint written over (2, 2)
resumes to the uninterrupted losses over (2, 2) and on one rank, and
one written on one rank resumes over (2, 2); under a 256-rank group
``train`` takes the production mesh and places by the FSDP rules; a
replicated leaf placed on ranks is a copy (the ranks' writes never
reach the caller's tensor); a per-weight cache hands autograd the
value made from the weight itself."""
import concurrent.futures

import numpy as np
import pytest
import torch

import _torch_ranks_train as H
from _torch_ranks import flat_leaves, jobs_worker, port_spec, spawn
from repro_torch import tree as T
from repro_torch.dist import sharding as S, spmd
from repro_torch.kernels import ops
from repro_torch.launch import mesh as MESH
from repro_torch.launch.train import train, train_init
from repro_torch.launch import steps
from repro_torch.models import transformer as M

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"
RUN = dict(arch=ARCH, steps=H.STEPS, batch=H.B, seq=H.T_SEQ, lr=H.LR,
           chunk=H.CHUNK)
JOBS = [dict(RUN, key="2x2", shape=[2, 2], precision="bnn_train",
             microbatches=[1, 2]),
        dict(RUN, key="1x4", shape=[1, 4], precision="bnn_train",
             microbatches=[1, 2]),
        dict(RUN, key="2x2-bf16", shape=[2, 2], precision="bf16",
             microbatches=[1], steps=1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks_train")
    jax_run = H.JaxTrainRun(tmp, JOBS)
    params = {(ARCH, p): H.jax_params(ARCH, p) for p in ("bnn_train", "bf16")}
    whole = params[(ARCH, "bnn_train")]
    dirs = {k: str(tmp / k) for k in ("mesh", "mesh_copy", "one")}
    kw = dict(smoke=True, global_batch=H.B, seq_len=H.T_SEQ, lr=H.LR,
              schedule_total=H.STEPS, precision="bnn_train", device="cpu",
              log_every=10 ** 6)

    def one_rank(**more):
        return train(ARCH, params=_copy_params(whole, H.port_cfg(ARCH)),
                     **kw, **more)
    # a one-rank checkpoint at step STEPS - 1, for the ranks to resume
    first_one = one_rank(steps=H.STEPS - 1, ckpt_dir=dirs["one"],
                         ckpt_every=1)
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(spawn, jobs_worker, 4, [
        (H.train_worker, (JOBS, params)),
        (H.resume_worker, (ARCH, whole, (2, 2), dirs)),
        (H.missing_grad_worker, (ARCH, whole, (2, 2)))])
    ex.shutdown(wait=False)
    one = {"whole": one_rank(steps=H.STEPS), "first": first_one}
    ranks = fut.result()
    # the checkpoint the ranks wrote at STEPS - 1, resumed on one rank
    one["from_mesh"] = one_rank(steps=H.STEPS, ckpt_dir=dirs["mesh_copy"])
    return {"ranks": ranks, "jax": jax_run.result(), "one": one}


def _copy_params(params, cfg) -> dict:
    """A copy of ``params`` (a tied head the copy's embedding's
    transpose)."""
    out = {k: T.map_(torch.clone, v) for k, v in params.items()
           if k != "head"}
    out["head"] = ({"w": out["embed"]["w"].t()} if cfg.tie_embeddings
                   else T.map_(torch.clone, params["head"]))
    return out


@pytest.mark.parametrize("key", [j["key"] for j in JOBS])
def test_train_over_ranks_vs_jax(runs, key):
    job = next(j for j in JOBS if j["key"] == key)
    H.check_job([r[0] for r in runs["ranks"]], runs["jax"][key], job)


def test_a_leaf_without_gradient_raises_over_a_mesh(runs):
    for r in runs["ranks"]:
        err = r[2]
        assert err is not None and "layers/0/attn/unread" in err, err
    # one rank: JAX's zeros for a leaf the batch never reaches
    cfg = H.port_cfg(ARCH)
    p = _copy_params(H.jax_params(ARCH), cfg)
    p["layers"][0]["attn"]["unread"] = torch.ones(4)
    _, _, grads = steps.value_and_grad(p, cfg, H.batch(cfg, 0),
                                       loss_chunk=H.CHUNK, remat=False)
    assert torch.equal(grads["layers"][0]["attn"]["unread"], torch.zeros(4))


def test_checkpoints_resume_across_meshes(runs):
    one = runs["one"]
    n = H.STEPS - 1
    for r in runs["ranks"]:
        got = r[1]
        # over (2, 2): the same losses as one rank, within the loss bound
        np.testing.assert_allclose(got["whole"], one["whole"], rtol=1e-5)
        assert got["first"] == got["whole"][:n]
        # resumed over (2, 2) from its own checkpoint: the same steps
        assert got["resumed"] == got["whole"][n:]
        # resumed over (2, 2) from the one-rank checkpoint
        assert len(got["from_one"]) == 1
        np.testing.assert_allclose(got["from_one"], one["whole"][n:],
                                   rtol=1e-5)
    assert one["first"] == one["whole"][:n]
    # the (2, 2) checkpoint resumed on one rank
    assert len(one["from_mesh"]) == 1
    np.testing.assert_allclose(one["from_mesh"], one["whole"][n:], rtol=1e-5)


def test_train_takes_the_production_mesh_and_the_fsdp_rules():
    """As the JAX launcher: under a 256-rank group a non-smoke ``train``
    builds the (16, 16) ("data", "model") mesh (``launch_mesh``) and
    places the params by ``rules_train(False, fsdp=True)`` (the reduced
    config's here); a smoke run takes one device; ``--multi-pod`` needs
    512 ranks."""
    cfg = H.port_cfg(ARCH)
    with MESH.fake_world(256):
        m = MESH.launch_mesh(device="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.shape == (16, 16)
        assert MESH.launch_mesh(smoke=True, device="cpu") is None
        with pytest.raises(ValueError, match="512"):
            MESH.launch_mesh(multi_pod=True, device="cpu")
        with pytest.raises(ValueError, match="512"):
            train(ARCH, multi_pod=True, device="cpu", steps=0)
        params = train_init(cfg, "cpu", 0, m)
        specs = M.param_specs(cfg)
        assert S.train_rules_of(m) == S.rules_train(False, fsdp=True)
        want = S.param_shardings(m, M.trainable(params, cfg), specs,
                                 S.rules_train(False, fsdp=True))
        got = S.map_specs(lambda a, t: list(t.placements), specs,
                          M.trainable(params, cfg))
        assert got == want
        # embed over (model, data), the norms over data
        specs_got = {k: port_spec(v) for k, v in
                     flat_leaves(M.trainable(params, cfg)).items()}
        assert specs_got["embed/w"] == ("model", "data")
        assert specs_got["final_norm/scale"] == ("data",)
        assert specs_got["layers/0/attn/q/w"] == ("data", "model")
        assert specs_got["layers/0/attn/o/w"] == ("model", "data")
    assert not torch.distributed.is_initialized()


def test_a_placed_replicated_leaf_is_a_copy():
    """``spmd.place`` keeps a copy of a leaf held whole on every rank: a
    rank's in-place write (the optimizer's) never reaches the tensor it
    was placed from, which spawned ranks share (torch.multiprocessing
    hands them shared memory)."""
    from torch.distributed.device_mesh import init_device_mesh
    t = torch.arange(4.0)
    with MESH.fake_world(4):
        m = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        x = spmd.place(t, m, S.replicated(m))
        spmd.local(x).add_(1.0)
    assert torch.equal(t, torch.arange(4.0))


def test_cached_per_weight_stays_in_the_graph_under_autograd():
    """Where autograd wants the weight's gradient the cache hands back
    ``make(w)`` itself (its gradient flows to ``w``); under no_grad the
    cached value, detached, made once per version."""
    w = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    made = []

    def make(x):
        made.append(1)
        return x * 2.0
    y = ops.cached_per_weight(w, ("test_grad",), make)
    y.sum().backward()
    assert torch.equal(w.grad, torch.full((2, 3), 2.0))
    with torch.no_grad():
        a = ops.cached_per_weight(w, ("test_grad",), make)
        b = ops.cached_per_weight(w, ("test_grad",), make)
    assert a is b and not a.requires_grad and len(made) == 2


def test_adamw_on_shards_moves_each_dtensor_version():
    """AdamW writes each rank's shards in place, which does not move the
    DTensor's own ``_version``; ``update`` moves it, so a value cached
    under the weight (``ops.cached_per_weight``: a packed weight, MLA's
    up projections) is made again after a step.  The norm of DTensor
    gradients counts each leaf once (a fake group: every all-reduce
    leaves the local sum)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.optim import optimizer as opt
    with MESH.fake_world(4):
        m = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        w = spmd.place(torch.arange(16.0).reshape(4, 4), m, S.replicated(m))
        g = spmd.place(torch.full((4, 4), 0.5), m, S.replicated(m))
        made = []
        with torch.no_grad():
            ops.cached_per_weight(w, ("test_version",), made.append)
            ocfg = opt.AdamWConfig(lr_peak=1e-2, warmup_steps=0)
            state = opt.init(ocfg, {"w": w})
            assert spmd.is_dtensor(state["m"]["w"])
            v0 = w._version
            _, _, met = opt.update(ocfg, {"w": g}, state, {"w": w})
            assert w._version > v0
            ops.cached_per_weight(w, ("test_version",), made.append)
        assert len(made) == 2
        np.testing.assert_allclose(float(met["grad_norm"]), 2.0, rtol=1e-6)
        assert not torch.equal(spmd.local(w), torch.arange(16.0).reshape(4, 4))
