"""Shared pieces of the tests of training over several ranks
(tests/test_torch_ranks_train*.py): JAX's FSDP train run on a mesh of 4
forced host devices in a subprocess (``JaxTrainRun``, started beside
the ranks, as ``_torch_ranks.JaxMeshRun`` is), the rank worker that
trains the port over meshes of gloo ranks (``train_worker``), and the
comparisons.  The weights are the JAX package's ``init(PRNGKey(0))``
at "bnn_train" (or the precision asked), converted by
``interop.params_from_numpy``; the batches ``SyntheticLM``'s, bit-equal
in both packages.  The bounds are those of the one-rank training tests
(tests/test_torch_train_step.py, tests/_torch_train.py)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from _torch_ranks import REPO, flat_leaves, mesh, port_spec
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced

GRAD_REL = 1e-5          # each leaf within this x its largest |element|
LOSS_REL = 1e-6
NORM_REL = 1e-5
LR = 1e-3
# the one-rank step test's bound (tests/test_torch_train_step.py)
PARAM_TOL = dict(rtol=5e-3, atol=1e-3 * LR / 1e-2)
B, T_SEQ, STEPS = 8, 32, 3
CHUNK = min(512, T_SEQ)   # launch.train's loss chunk


def port_cfg(arch: str, precision: str = "bnn_train"):
    return treduced(tconfigs.get_config(arch)).replace(precision=precision)


JAX_TRAIN_RUN = textwrap.dedent('''
    import json
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro import configs
    from repro.configs.base import reduced
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.dist import sharding as S
    from repro.launch import steps as ST
    from repro.layers import common as C
    from repro.models import transformer as M
    from repro.optim import optimizer as O
    dst, jobs = sys.argv[1:3]
    jobs = json.loads(jobs)

    def spec(a):
        s = tuple(a.sharding.spec)
        s = s + (None,) * (a.ndim - len(s))
        return [list(e) if isinstance(e, tuple) else e for e in s]

    def walk(t, path, drop, out):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,), drop, out)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,), drop, out)
        else:
            out["/".join(map(str, path))] = spec(t)[1:] if drop else spec(t)

    def port_layout(cfg, params):
        out = {}
        for k, v in params.items():
            if k != "segments":
                walk(v, (k,), False, out)
        li = 0
        for (kind, plan, n), seg in zip(M.segments(cfg), params["segments"]):
            for gi in range(n):
                for j in range(len(plan)):
                    if kind == "unroll":
                        walk(seg[j], ("layers", li), False, out)
                    else:
                        walk(seg[f"l{j}"], ("layers", li), True, out)
                    li += 1
        return out

    arrays, meta = {}, {}
    for job in jobs:
        key, shape = job["key"], tuple(job["shape"])
        cfg = reduced(configs.get_config(job["arch"])).replace(
            precision=job["precision"])
        params0, specs = M.init(jax.random.PRNGKey(0), cfg)
        rules = S.rules_train(False, fsdp=True)
        devs = np.asarray(jax.devices()[:shape[0] * shape[1]])
        mesh = Mesh(devs.reshape(shape), ("data", "model"))
        data = SyntheticLM(DataConfig(cfg.vocab, job["seq"], job["batch"],
                                      seed=0))
        opt_cfg = O.AdamWConfig(lr_peak=job["lr"],
                                warmup_steps=max(job["steps"] // 10, 1),
                                total_steps=job["steps"])

        def one_batch_step(p, st, b):
            # build_train_step's microbatches == 1 path, its gradients
            # returned beside its results
            (loss, met), g = jax.value_and_grad(
                lambda q, bb: M.loss_fn(q, cfg, bb, loss_chunk=job["chunk"],
                                        remat=True), has_aux=True)(p, b)
            p2, st2, om = O.update(opt_cfg, g, st, p)
            return p2, st2, {"loss": loss, **om}, met, g
        m = {}
        with C.sharding_context(mesh, rules):
            params = jax.device_put(params0, S.param_shardings(
                mesh, params0, specs, rules))
            m["params"] = port_layout(cfg, params)
            for mb in job["microbatches"]:
                step = jax.jit(one_batch_step if mb == 1 else
                               ST.build_train_step(cfg, opt_cfg,
                                                   microbatches=mb,
                                                   loss_chunk=job["chunk"]))
                p, st = params, O.init(opt_cfg, params)
                hist = []
                for s in range(job["steps"]):
                    res = step(p, st, jax.tree.map(jnp.asarray,
                                                   data.batch(s)))
                    p, st, out = res[:3]
                    hist.append({k: float(v) for k, v in out.items()})
                    if mb == 1 and s == 0:
                        met, grads = res[3:]
                        m["loss"], m["xent"] = float(out["loss"]), \
                            float(met["xent"])
                        m["aux"] = float(met["aux"])
                        m["grad_norm"] = float(O.global_norm(grads))
                        for i, g in enumerate(jax.tree.leaves(grads)):
                            arrays[f"{key}/grad/{i}"] = np.asarray(g)
                m[f"mb{mb}"] = hist
                for i, x in enumerate(jax.tree.leaves(p)):
                    arrays[f"{key}/mb{mb}/{i}"] = np.asarray(x)
        meta[key] = m
    np.savez(dst, **arrays)
    print("META", json.dumps(meta))
''')


class JaxTrainRun:
    """JAX's ``build_train_step`` for each job's ``steps`` steps
    (launch.train's AdamW and batches), with the step-0 gradients of its
    one-microbatch path, on the reduced ``arch`` under
    ``rules_train(False, fsdp=True)`` on the job's ``Mesh`` (4 forced
    host devices), in a fresh process started here; ``result()`` waits
    for it.  A job: {"key", "arch", "shape", "precision", "microbatches"
    (1 among them), "steps", "batch", "seq", "lr", "chunk"}."""

    def __init__(self, tmp: Path, jobs: list[dict]):
        self.jobs = jobs
        self.dst = tmp / "jax_train.npz"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", JAX_TRAIN_RUN, str(self.dst),
             json.dumps(jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)

    def result(self) -> dict:
        """{key: {"params" ({leaf path: PartitionSpec}), "loss", "xent",
        "aux", "grad_norm", "grads" (the port's trainable tree), and per
        microbatch count g "mb{g}" (each step's metrics) and
        ("final", g) (the params after the last step, the port's
        trainable tree)}}."""
        import jax
        from _torch_train import to_port
        from repro import configs as jconfigs
        from repro.configs.base import reduced as jreduced
        from repro.models import transformer as JM
        out, err = self.proc.communicate(timeout=600)
        assert self.proc.returncode == 0, err
        meta = json.loads(out.split("META ")[1])
        arrays = np.load(self.dst)
        res = {}
        for job in self.jobs:
            key = job["key"]
            jcfg = jreduced(jconfigs.get_config(job["arch"])).replace(
                precision=job["precision"])
            tdef = jax.tree.structure(
                jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0),
                                               jcfg)[0]))
            tcfg = port_cfg(job["arch"], job["precision"])

            def tree(prefix):
                leaves = [arrays[f"{prefix}/{i}"]
                          for i in range(tdef.num_leaves)]
                return to_port(jax.tree.unflatten(tdef, leaves), tcfg)
            m = meta[key]
            r = {k: m[k] for k in ("loss", "xent", "aux", "grad_norm")}
            r["params"] = {k: _spec(v) for k, v in m["params"].items()}
            r["grads"] = tree(f"{key}/grad")
            for mb in job["microbatches"]:
                r[f"mb{mb}"] = m[f"mb{mb}"]
                r[("final", mb)] = tree(f"{key}/mb{mb}")
            res[key] = r
        return res


def _spec(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def jax_params(arch: str, precision: str = "bnn_train"):
    """JAX's ``init(PRNGKey(0))`` of the reduced ``arch``, converted to
    the port's params."""
    import jax
    from repro import configs as jconfigs
    from repro.configs.base import reduced as jreduced
    from repro.models import transformer as JM
    from repro_torch.interop import params_from_numpy
    jcfg = jreduced(jconfigs.get_config(arch)).replace(precision=precision)
    jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    return params_from_numpy(jax.tree.map(np.asarray, jp),
                             port_cfg(arch, precision))


def batch(cfg, step: int, b: int = B, t: int = T_SEQ) -> dict:
    """``SyntheticLM``'s batch ``step`` as launch.train draws it."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_tensors
    return to_tensors(SyntheticLM(DataConfig(cfg.vocab, t, b, seed=0))
                      .batch(step), "cpu")


def train_worker(world, jobs, params_of):
    """One rank: for each job (JaxTrainRun's; ``shape`` a mesh of this
    world; ``params_of[(arch, precision)]`` its weights, whole), the
    params placed by the FSDP train rules (their
    placements), step 0's ``value_and_grad`` (loss, metrics, every
    gradient gathered whole, the global norm), then for each microbatch
    count ``launch.train`` over the mesh for ``steps`` steps from the
    same weights: each step's metrics and the params gathered whole."""
    from repro_torch.dist import sharding as S
    from repro_torch.launch import steps
    from repro_torch.launch.train import train
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    from repro_torch.optim import optimizer as opt
    out = {}
    for job in jobs:
        if job["shape"][0] * job["shape"][1] != world.size:
            continue
        arch = job["arch"]
        cfg = port_cfg(arch, job["precision"])
        params = params_of[(arch, job["precision"])]
        m = mesh(job["shape"])
        rules = S.train_rules_of(m)
        tp = S.place_params(params, cfg, m, rules)
        rec = {"placements": {k: port_spec(v) for k, v in
                              flat_leaves(M.trainable(tp, cfg)).items()}}
        with C.sharding_context(m, rules):
            loss, met, grads = steps.value_and_grad(
                tp, cfg, batch(cfg, 0, job["batch"], job["seq"]),
                loss_chunk=job["chunk"], remat=False)
            rec["grad_norm"] = float(opt.global_norm(grads))
        rec.update(loss=float(loss), xent=float(met["xent"]),
                   aux=float(met["aux"]), grads=S.gather_tree(grads),
                   grad_placements={k: port_spec(v) for k, v in
                                    flat_leaves(grads).items()})
        for mb in job["microbatches"]:
            tp = S.place_params(params, cfg, m, rules)
            hist: list = []
            train(arch, smoke=True, steps=job["steps"],
                  global_batch=job["batch"], seq_len=job["seq"],
                  microbatches=mb, lr=job["lr"], precision=job["precision"],
                  device="cpu", params=tp, mesh=m, metrics=hist,
                  log_every=10 ** 6)
            rec[f"mb{mb}"] = hist
            rec[("final", mb)] = S.gather_tree(M.trainable(tp, cfg))
            # a tied head is still the trained embedding's transpose
            rec[("tied", mb)] = not cfg.tie_embeddings or bool(torch.equal(
                S.gather_tree(tp["head"])["w"],
                rec[("final", mb)]["embed"]["w"].t()))
        out[job["key"]] = rec
    return out


def check_job(ranks, want, job, grad_rel_by_name=None):
    """Every rank's ``train_worker`` record of ``job`` against JAX's run
    (``JaxTrainRun.result()[key]``): the placements; step 0's loss,
    xent, aux, every gradient and the global norm; each step's loss,
    grad_norm and lr, and the params after the last step."""
    from _torch_train import assert_leaves_close, np_
    from repro_torch import tree as T
    key = job["key"]
    for r, rank in enumerate(ranks):
        got = rank[key]
        assert got["placements"] == want["params"], (key, r)
        # each gradient placed as its leaf
        assert got["grad_placements"] == got["placements"], (key, r)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_REL)
        np.testing.assert_allclose(got["xent"], want["xent"], rtol=LOSS_REL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=NORM_REL)
        assert_leaves_close(got["grads"], want["grads"], GRAD_REL,
                            f"{key} rank {r}", grad_rel_by_name)
        for gl, wl in zip(T.leaves(got["grads"]), T.leaves(want["grads"])):
            # no zero gradient where JAX's is not
            assert np_(gl).any() or not np_(wl).any(), key
        for mb in job["microbatches"]:
            for s, (g, w) in enumerate(zip(got[f"mb{mb}"], want[f"mb{mb}"],
                                           strict=True)):
                np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5,
                                           err_msg=f"{key} mb{mb} step {s}")
                np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                           rtol=NORM_REL)
                np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
            for a, b in zip(T.leaves(got[("final", mb)]),
                            T.leaves(want[("final", mb)]), strict=True):
                np.testing.assert_allclose(np_(a), np_(b), **PARAM_TOL)
            assert got[("tied", mb)]


def resume_worker(world, arch, params, shape, ckpt_dirs):
    """Over a ``shape`` mesh, from ``params`` (whole): ``launch.train``
    for ``STEPS`` steps uninterrupted; then to step ``STEPS - 1`` with a
    checkpoint a step into ``ckpt_dirs["mesh"]`` (copied, on the lead
    rank, to ``ckpt_dirs["mesh_copy"]`` for a one-rank resume), resumed
    to ``STEPS``; and resumed to ``STEPS`` from the one-rank checkpoint
    in ``ckpt_dirs["one"]``.  The losses of each run."""
    import shutil
    from repro_torch.dist import sharding as S
    from repro_torch.launch.train import train
    cfg = port_cfg(arch)
    m = mesh(shape)
    rules = S.train_rules_of(m)
    kw = dict(smoke=True, global_batch=B, seq_len=T_SEQ, lr=LR,
              schedule_total=STEPS, precision="bnn_train", device="cpu",
              mesh=m, log_every=10 ** 6)

    def fresh():
        return S.place_params(params, cfg, m, rules)
    out = {"whole": train(arch, steps=STEPS, params=fresh(), **kw)}
    out["first"] = train(arch, steps=STEPS - 1, params=fresh(),
                         ckpt_dir=ckpt_dirs["mesh"], ckpt_every=1, **kw)
    if world.rank == 0:
        shutil.copytree(ckpt_dirs["mesh"], ckpt_dirs["mesh_copy"])
    out["resumed"] = train(arch, steps=STEPS, params=fresh(),
                           ckpt_dir=ckpt_dirs["mesh"], **kw)
    out["from_one"] = train(arch, steps=STEPS, params=fresh(),
                            ckpt_dir=ckpt_dirs["one"], **kw)
    return out


def missing_grad_worker(world, arch, params, shape):
    """Over a ``shape`` mesh, ``value_and_grad`` of params holding a leaf
    the model never reads: the error it raises (None: none raised)."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.launch import steps
    from repro_torch.layers import common as C
    cfg = port_cfg(arch)
    m = mesh(shape)
    rules = S.train_rules_of(m)
    tp = S.place_params(params, cfg, m, rules)
    tp["layers"][0]["attn"]["unread"] = spmd.place(torch.ones(4), m,
                                                  S.replicated(m))
    try:
        with C.sharding_context(m, rules):
            steps.value_and_grad(tp, cfg, batch(cfg, 0), loss_chunk=CHUNK,
                                 remat=False)
    except RuntimeError as e:
        return str(e)
    return None


def grads_worker(world, cfg, params, shape):
    """Over a ``shape`` mesh, ``value_and_grad`` of ``params`` (whole)
    placed by the FSDP train rules on batch 0: the loss, the aux loss,
    every gradient gathered whole and the global norm."""
    from repro_torch.dist import sharding as S
    from repro_torch.launch import steps
    from repro_torch.layers import common as C
    from repro_torch.optim import optimizer as opt
    m = mesh(shape)
    rules = S.train_rules_of(m)
    tp = S.place_params(params, cfg, m, rules)
    with C.sharding_context(m, rules):
        loss, met, grads = steps.value_and_grad(tp, cfg, batch(cfg, 0),
                                                loss_chunk=CHUNK,
                                                remat=True)
        norm = float(opt.global_norm(grads))
    return {"loss": float(loss), "aux": float(met["aux"]), "grad_norm": norm,
            "grads": S.gather_tree(grads),
            "down": port_spec(tp["layers"][0]["ffn"]["down"])}


def _float32_shapes():
    """A dispatch mode that keeps the shape of every float32 tensor an
    op makes while it is on (``shapes``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes: list[tuple] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and \
                        t.dtype == torch.float32:
                    self.shapes.append(tuple(t.shape))
            return out
    return Shapes()


def loss_worker(world, cases, params_of, batch_of):
    """One rank: for each case ({"key", "shape" (a mesh of this world),
    "chunk", "remat"}; ``params_of[key]`` its config and weights, whole;
    ``batch_of[key]`` its batch), the params placed by the FSDP train
    rules, then ``value_and_grad`` over the mesh: the loss, every
    gradient gathered whole; which chunk functions of ``loss_fn`` ran,
    the float32 shapes they made, and the all-gathers over ``model``
    whose input is the head's own shard (the head gathered over the
    vocab's cut).  Then, as a check of that watch, ``spmd.full`` of the
    head under it."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.launch import steps
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    out = {}
    for case in cases:
        key = case["key"]
        cfg, params = params_of[key]
        m = mesh(case["shape"])
        rules = S.train_rules_of(m)
        tp = S.place_params(params, cfg, m, rules)
        head = tp["embed"]["w"] if cfg.tie_embeddings else tp["head"]["w"]
        own = head.to_local().untyped_storage().data_ptr()
        rec = {"chunks": [], "shapes": [], "head_gathers": 0}
        gather, chunk_fns = spmd._all_gather, {}

        def watch_gather(t, mesh_, dim, along):
            if mesh_.mesh_dim_names[dim] == "model" and \
                    t.untyped_storage().data_ptr() == own:
                rec["head_gathers"] += 1
            return gather(t, mesh_, dim, along)

        def watch(name):
            fn = getattr(M, name)
            chunk_fns[name] = fn

            def run(*args, **kw):
                rec["chunks"].append(name)
                with _float32_shapes() as mode:
                    res = fn(*args, **kw)
                rec["shapes"].extend(mode.shapes)
                return res
            return run
        spmd._all_gather = watch_gather
        M._chunk_nll = watch("_chunk_nll")
        M._chunk_nll_cut = watch("_chunk_nll_cut")
        try:
            with C.sharding_context(m, rules):
                loss, met, grads = steps.value_and_grad(
                    tp, cfg, batch_of[key], loss_chunk=case["chunk"],
                    remat=case["remat"])
                rec["loss_head_gathers"] = rec["head_gathers"]
                spmd.full(head)
        finally:
            spmd._all_gather = gather
            for name, fn in chunk_fns.items():
                setattr(M, name, fn)
        rec.update(loss=float(loss), xent=float(met["xent"]),
                   grads=S.gather_tree(grads))
        out[key] = rec
    return out
