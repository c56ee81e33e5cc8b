"""Shared pieces of the tests of the forward over several ranks
(tests/test_torch_ranks*.py): the reduced bnn-lm-100m (or another
arch: mixtral, deepseek-v2-lite, llama3.2-3b) at precision "bnn",
meshes of real ``gloo`` ranks on the CPU
(``launch/mesh.spawn_ranks``: one ``spawn`` of a world per test file
and world size, every mesh of that size built in it), and the rank
workers.  A worker is a module-level function of this module (the
ranks import it by name); it returns plain tensors and lists, whole on
every rank, and the tests compare what every rank returned.

Inputs are made from numpy seeds; the weights are the JAX package's
``init(PRNGKey(0))`` converted by ``interop.params_from_numpy``, handed
to the ranks whole: each rank keeps its slices (``place_params``)."""
import contextlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.serving import Engine, EngineConfig, SamplingParams

REPO = Path(__file__).resolve().parent.parent
# the engine sizes of the JAX package's own role and sharding tests
EKW = dict(block_size=4, num_blocks=33, max_batch=4, prefill_chunk=4,
           max_model_len=32)
ARCH = "bnn-lm-100m"


def port_cfg(precision: str = "bnn", arch: str = ARCH):
    return treduced(tconfigs.get_config(arch)).replace(precision=precision)


def jax_cfg(arch: str = ARCH):
    from repro import configs
    from repro.configs.base import reduced
    return reduced(configs.get_config(arch)).replace(precision="bnn")


def jax_models(arch: str):
    """(JAX cfg, JAX params, the port's params) of the reduced ``arch``
    at "bnn": JAX's ``init(PRNGKey(0))``, converted."""
    import jax
    from repro.models import transformer as JM
    from repro_torch.interop import params_from_numpy
    jcfg = jax_cfg(arch)
    jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                       port_cfg(arch=arch))


def port_spec(x) -> tuple:
    """A DTensor's placements as a JAX ``PartitionSpec`` tuple, one entry
    a tensor dim: the mesh dim name(s) that cut it, or None."""
    names = x.device_mesh.mesh_dim_names
    out = []
    for d in range(x.ndim):
        cut = tuple(names[i] for i, p in enumerate(x.placements)
                    if p.is_shard() and p.dim == d)
        out.append(None if not cut else cut[0] if len(cut) == 1 else cut)
    return tuple(out)


def flat_leaves(tree, path=()) -> dict:
    """{"a/b/0/w": leaf} over a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"/".join(map(str, path)): tree}
    out = {}
    for k, v in items:
        out.update(flat_leaves(v, path + (k,)))
    return out


def mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))


def spawn(fn, size: int, *args):
    from repro_torch.launch.mesh import spawn_ranks
    return spawn_ranks(fn, size, *args, timeout_s=240.0)


def spawn_worlds(fn, worlds, args_of):
    """``spawn(fn, size, *args_of(shapes))`` for each (size, shapes) of
    ``worlds`` in turn, in a thread: a future of {size: each rank's
    result}, so the caller builds its references while the ranks run."""
    import concurrent.futures
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(lambda: {size: spawn(fn, size, *args_of(shapes))
                             for size, shapes in worlds})
    ex.shutdown(wait=False)
    return fut


def prompts(vocab: int, lens, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def shared_prompts(vocab: int) -> list[np.ndarray]:
    """Prompts on one shared head of 8 tokens (two blocks of 4 on the
    chunk grid, so slot snapshots land there) and tails of 1-5."""
    rng = np.random.default_rng(7)
    head = rng.integers(0, vocab, 8)
    return [np.concatenate([head, rng.integers(0, vocab, n)]).astype(np.int32)
            for n in (3, 2, 5, 1)]


def sampling(pkg: str):
    """Request i's sampling parameters in either package (seeded by i)."""
    if pkg == "jax":
        from repro.serving import SamplingParams as P
    else:
        P = SamplingParams
    return lambda i: P(temperature=0.8, top_k=20, top_p=0.9, seed=100 + i)


# --------------------------------------------------------------- JAX mesh

JAX_MESH_RUN = textwrap.dedent('''
    import json
    import sys
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro import configs
    from repro.configs.base import reduced
    from repro.dist import sharding as S
    from repro.launch import steps as ST
    from repro.layers import common as C
    from repro.models import transformer as M
    arch, src, dst, shapes, runs = sys.argv[1:6]
    cfg = reduced(configs.get_config(arch)).replace(precision="bnn")
    params0, specs = M.init(jax.random.PRNGKey(0), cfg)
    rules = S.rules_decode(False)
    # the tokens, or a batch of the stub front-ends' inputs
    batch = dict(np.load(src)) if src.endswith(".npz") else \
        {"tokens": np.load(src)}

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

    def port_layout(params):
        # the port's one dict a layer (interop.params_from_numpy's walk);
        # a scanned leaf's "layers" entry dropped
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
    for key in shapes.split(","):
        shape = tuple(int(n) for n in key.split("x"))
        devs = np.asarray(jax.devices()[:shape[0] * shape[1]])
        mesh = Mesh(devs.reshape(shape), ("data", "model"))
        params = jax.device_put(params0, S.param_shardings(mesh, params0,
                                                           specs, rules))
        meta[key] = {"params": port_layout(params)}
        if key not in runs.split(","):
            continue
        with C.sharding_context(mesh, rules):
            logits = jax.jit(lambda p, b: M.logits_fn(p, cfg, b))(params,
                                                                  batch)
            pre = jax.jit(ST.build_prefill_step(cfg))(params, batch)
        arrays[key + "/logits"] = np.asarray(logits)
        arrays[key + "/prefill"] = np.asarray(pre)
        meta[key]["logits"] = spec(logits)
    np.savez(dst, **arrays)
    print("META", json.dumps(meta))
''')


def _spec(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _key(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


class JaxMeshRun:
    """JAX's ``logits_fn`` and ``build_prefill_step`` on the reduced
    ``arch`` at "bnn" under a ``Mesh`` of each of ``runs`` (4 forced
    host devices, the decode rules), and its params' placements under
    each of ``shapes``, in a fresh process (the device count is fixed
    when JAX starts), started here: ``result()`` waits for it.
    ``tokens``: the tokens, or a batch dict (the stub front-ends'
    ``embeds`` / ``prefix_embeds`` beside any tokens)."""

    def __init__(self, arch: str, tokens, tmp: Path, shapes, runs=None):
        self.shapes = [tuple(s) for s in shapes]
        self.runs = self.shapes if runs is None else [tuple(s) for s in runs]
        self.dst = tmp / "out.npz"
        if isinstance(tokens, dict):
            src = tmp / "batch.npz"
            np.savez(src, **tokens)
        else:
            src = tmp / "tokens.npy"
            np.save(src, tokens)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", JAX_MESH_RUN, arch, str(src), str(self.dst),
             ",".join(map(_key, self.shapes)), ",".join(map(_key, self.runs))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)

    def result(self) -> dict:
        """{shape: {"params" ({leaf path: PartitionSpec} in the port's
        layout), and for a run "logits", "prefill", "spec" (the logits'
        PartitionSpec)}}."""
        out, err = self.proc.communicate(timeout=240)
        assert self.proc.returncode == 0, err
        meta = json.loads(out.split("META ")[1])
        arrays = np.load(self.dst)
        res = {}
        for shape in self.shapes:
            m = meta[_key(shape)]
            res[shape] = {"params": {k: _spec(v)
                                     for k, v in m["params"].items()}}
            if shape in self.runs:
                res[shape].update(
                    logits=arrays[_key(shape) + "/logits"],
                    prefill=arrays[_key(shape) + "/prefill"],
                    spec=_spec(m["logits"]))
        return res


def jax_mesh_logits(tokens: np.ndarray, tmp: Path) -> tuple[np.ndarray,
                                                             tuple]:
    """JAX's ``logits_fn`` on the reduced bnn-lm-100m under a 2x2
    ``Mesh`` (``JaxMeshRun``): (logits, their PartitionSpec)."""
    run = JaxMeshRun(ARCH, tokens, tmp, [(2, 2)]).result()[(2, 2)]
    return run["logits"], run["spec"]


def jax_one_device(arch: str, jcfg, jparams, tokens: np.ndarray,
                   n_new: int) -> dict:
    """JAX's one-device ``logits_fn``, prefill step, and decode-step
    tokens (the prompt a token a step over the legacy caches, then
    ``n_new`` greedy)."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    from repro.models import transformer as JM
    b, t = tokens.shape
    logits = np.asarray(JM.logits_fn(jparams, jcfg,
                                     {"tokens": jnp.asarray(tokens)}))
    pre = np.asarray(jax.jit(jsteps.build_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)}))
    dec = jax.jit(jsteps.build_decode_step(jcfg))
    caches = JM.init_cache(jcfg, b, t + n_new)
    cur, seq = tokens[:, :1], [tokens[:, :1]]
    for i in range(t + n_new - 1):
        nxt, caches = dec(jparams, caches,
                          {"tokens": jnp.asarray(cur), "length": jnp.int32(i)})
        cur = tokens[:, i + 1:i + 2] if i + 1 < t else \
            np.asarray(nxt)[:, None]
        seq.append(cur)
    return {"logits": logits, "prefill": pre,
            "decode": np.concatenate(seq, axis=1)}


def jax_engine_tokens(jcfg, jparams, prompts, max_new: int, ekw: dict
                      ) -> list:
    """One JAX ``Engine`` (the XLA paths, ``EKW`` updated by ``ekw``),
    greedy then sampled: the tokens of each run, per request."""
    from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
    eng = JEngine(jparams, jcfg, JEngineConfig(
        **{**EKW, **ekw}, attn_impl="xla", bnn_impl="xla"))
    out = []
    for samp in (None, sampling("jax")):
        rids = [eng.submit(p, max_new, **({"sampling": samp(i)} if samp
                                          else {}))
                for i, p in enumerate(prompts)]
        got = eng.run()
        out.append([got[r].tolist() for r in rids])
    return out


# --------------------------------------------------------------- workers


def gemm_worker(world, shapes, layer, xs):
    """Every projection of one layer (``layer``: name -> weight, whole)
    at "bnn" and "bf16", its input rows (``xs``: K -> (M, K) input)
    sharded over data and its weight placed by the decode rules, on
    each mesh of ``shapes``: {shape: {(precision, name): output whole}},
    the weight-cache's pack counts of a first and a second pass, and
    whether each placed weight gathers back to itself."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.kernels import ops
    from repro_torch.layers import attn_block, common as C, ffn
    specs = {**attn_block.specs(port_cfg()), **ffn.specs()}
    rules = S.rules_decode(False)
    out = {}
    for shape in shapes:
        m = mesh(shape)
        placed = {n: S.place_tree(w, specs[n], m, rules)
                  for n, w in layer.items()}
        res, packs = {}, []
        for _ in range(2):
            before = ops.packed_weight_cache_info()["packs"]
            for prec in ("bnn", "bf16"):
                for n, p in placed.items():
                    with C.sharding_context(m, rules):
                        x = C.lsc(xs[p["w"].shape[0]], "batch", None)
                        y = ops.bnn_dense(x, p["w"], precision=prec)
                    res[(prec, n)] = spmd.full(y)
                    res[("placements", n)] = [str(q) for q in
                                              p["w"].placements]
            packs.append(ops.packed_weight_cache_info()["packs"] - before)
        back = all(torch.equal(S.gather_tree(p)["w"], layer[n]["w"])
                   for n, p in placed.items())
        out[tuple(shape)] = {"out": res, "packs": packs, "round_trip": back}
    return out


def forward_worker(world, shapes, params, tokens, n_new, arch=ARCH,
                   cli=True):
    """On each mesh of ``shapes``: ``logits_fn`` over ``tokens`` (its
    placements and the logits whole), ``build_prefill_step``'s logits,
    ``build_decode_step`` fed the prompt a token a step over the legacy
    caches, then ``n_new`` greedy tokens, and (``cli``) the serve CLI's
    paged and legacy runs over the mesh (``tokens`` the prompts,
    ``n_new`` new); the collectives (``spmd.recording``) of the prefill
    step and of the second decode step."""
    from repro_torch import tree as T
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as MESH, serve as SV, steps
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    cfg = port_cfg(arch=arch)
    rules = S.rules_decode(False)
    tok = torch.from_numpy(tokens.astype(np.int64))
    b, t = tok.shape
    out = {}
    for shape in shapes:
        m = mesh(shape)
        tp = S.place_params(params, cfg, m)
        dec = steps.build_decode_step(cfg)
        caches = M.init_cache(cfg, b, t + n_new, mesh=m)
        events = {}
        with C.sharding_context(m, rules):
            lg = M.logits_fn(tp, cfg, tok)
            with spmd.recording() as events["prefill"]:
                pre = steps.build_prefill_step(cfg)(tp, {"tokens": tok})
            cur, seq = tok[:, :1], [tok[:, :1]]
            for i in range(t + n_new - 1):
                with spmd.recording() as ev:
                    nxt, caches = dec(tp, caches, {"tokens": cur,
                                                   "length": i})
                if i == 1:
                    events["decode"] = ev
                cur = tok[:, i + 1:i + 2] if i + 1 < t else \
                    nxt[:, None].long()
                seq.append(cur)
        out[tuple(shape)] = {
            "cached_bytes": ops.cached_bytes(MESH.CACHED_KINDS,
                                             T.leaves(tp)),
            "cache_kinds": sorted({k[1] for k in ops._weight_pack_cache}),
            "largest_cached": max((ops.cached_bytes((k[1],), [w])
                                   for w in T.leaves(tp)
                                   for k in list(ops._weight_pack_cache)
                                   if k[0] == id(w)), default=0),
            "logits_local": tuple(lg.to_local().shape),
            "logits": spmd.full(lg),
            "placements": [str(p) for p in lg.placements],
            "prefill": spmd.full(pre),
            "decode": torch.cat(seq, dim=1),
            "events": events,
            "serve": {engine: SV.serve(
                arch, smoke=True, precision="bnn", gen=n_new, device="cpu",
                engine=engine, params=params, prompts=tokens, mesh=m,
                verbose=False) for engine in ("paged", "legacy")}
            if cli else {}}
    return out


def serve(params, cfg, ps, max_new, *, mesh=None, sampled=False,
          check_ranks=False, **ekw):
    """One engine (EKW, updated by ``ekw``) over ``mesh`` (None: one
    rank) serving ``ps``, ``max_new`` new tokens each; (tokens per
    request, stats)."""
    eng = Engine(params, cfg, EngineConfig(**{**EKW, **ekw}), device="cpu",
                 mesh=mesh, check_ranks=check_ranks)
    samp = sampling("torch") if sampled else (lambda i: SamplingParams())
    rids = [eng.submit(p, max_new, sampling=samp(i))
            for i, p in enumerate(ps)]
    got = eng.run()
    return [got[r].tolist() for r in rids], eng.stats()


def engine_worker(world, shapes, params, ps, max_new, ekw, arch=ARCH):
    """On each mesh of ``shapes`` the engine (``serve``'s ``ekw``)
    serves ``ps`` greedy, then sampled, with the ranks' tokens compared
    at every step (``check_ranks``); the tokens, and what the schedule
    did."""
    from repro_torch.kernels import ops
    cfg = port_cfg(arch=arch)
    out = {}
    for shape in shapes:
        m = mesh(shape)
        runs = []
        for sampled in (False, True):
            ops.reset_launches()
            toks, st = serve(params, cfg, ps, max_new, mesh=m,
                             sampled=sampled, check_ranks=True, **ekw)
            runs.append({"tokens": toks,
                         "preemptions": st["preemptions"],
                         "max_concurrent": st["max_concurrent_decode"],
                         "prefix_hits": st["prefix_cache"]["hits"],
                         "swap_outs": st["swap"]["swap_outs"],
                         "ring_reuses": st["mixer"].get(
                             "blocks", {}).get("ring_reuses", 0)})
        out[tuple(shape)] = runs
    return out


# --------------------------------------------------------------- families


def family_worker(world, arch, shapes, params, tokens, n_new, prompts,
                  max_new, ekw):
    """``forward_worker`` (no CLI) and ``engine_worker`` on the reduced
    ``arch`` in one world: {"forward": ..., "engine": ...}."""
    return {"forward": forward_worker(world, shapes, params, tokens, n_new,
                                      arch=arch, cli=False),
            "engine": engine_worker(world, shapes, params, prompts, max_new,
                                    ekw, arch=arch)}


def port_placements(arch: str, params, shape) -> dict:
    """{leaf path: PartitionSpec tuple} of ``place_params`` on the
    reduced ``arch`` over a ``shape`` mesh of a fake group (placing runs
    no collective), in the port's layout (a tied head has no leaf)."""
    from repro_torch.dist import sharding as S
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import transformer as M
    cfg = port_cfg(arch=arch)
    with MESH.fake_world(shape[0] * shape[1]):
        placed = S.place_params(params, cfg, mesh(shape))
        return {k: port_spec(v) for k, v in
                flat_leaves(M.trainable(placed, cfg)).items()}


def check_family(ranks, shape, *, jax_mesh, jax_one, one_rank, tol):
    """Every rank's logits_fn, prefill step and decode tokens over
    ``shape``: the logits placed as JAX's (batch over data, vocab over
    model), within ``tol`` of JAX's same-mesh logits with its greedy
    tokens, and bit-equal to the port's one rank dispatching in as
    many groups as the mesh has data ranks; the prefill step within
    ``tol`` of JAX's same-mesh step with its tokens; the decode tokens
    JAX's one device's."""
    want = jax_mesh[shape]
    # a data axis of one device may be left out of JAX's spec
    assert want["spec"] in (("data", None, "model"), (None, None, "model"))
    assert want["spec"][0] == "data" or shape[0] == 1
    for rank in ranks:
        rec = rank["forward"][shape]
        got = rec["logits"].numpy()
        assert rec["placements"] == ["S(0)", "S(2)"]
        assert torch.equal(rec["logits"], one_rank[shape[0]])
        np.testing.assert_allclose(got, want["logits"], **tol)
        np.testing.assert_array_equal(got.argmax(-1),
                                      want["logits"].argmax(-1))
        pre = rec["prefill"].numpy()
        np.testing.assert_allclose(pre, want["prefill"], **tol)
        np.testing.assert_array_equal(pre.argmax(-1),
                                      want["prefill"].argmax(-1))
        np.testing.assert_array_equal(rec["decode"].numpy(),
                                      jax_one["decode"])


def prefill_logits(params, cfg, tokens: torch.Tensor, mesh=None):
    """``prefill_chunk`` of all of ``tokens`` (B, T) in one chunk over
    fresh pools (blocks of 4, a recurrent slot a row; over ``mesh``,
    placed and under its sharding context): the logits, whole."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    b, t = tokens.shape
    per = -(-t // 4)
    pools = M.init_paged_state(cfg, 1 + b * per, 4, 1 + b, mesh=mesh)
    table = (1 + torch.arange(b * per, dtype=torch.int32)).reshape(b, per)
    zeros = torch.zeros(b, dtype=torch.int32)
    ctx = (C.sharding_context(mesh, S.decode_rules_of(mesh))
           if mesh is not None else contextlib.nullcontext())
    with ctx, torch.no_grad():
        lg, _ = M.prefill_chunk(params, cfg, tokens, pools, table, zeros,
                                zeros + t, zeros + 1 + torch.arange(b))
    return spmd.full(lg)


def cases_worker(world, shape, cases, gemms):
    """Over a ``shape`` mesh: for each case (name -> (cfg, params,
    tokens)) ``logits_fn`` (the capacity-table MoE dispatch) and a
    one-chunk ``prefill_chunk`` (drop-free), the pools' placements by
    layer, whole; for each gemm (name -> (x, w, logical axes)) ``w``
    placed by its axes and ``bnn_dense`` at "bnn", whole."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.kernels import ops
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    m = mesh(shape)
    rules = S.rules_decode(False)
    out = {}
    for name, (cfg, params, tokens) in cases.items():
        tp = S.place_params(params, cfg, m)
        with C.sharding_context(m, rules), torch.no_grad():
            lg = M.logits_fn(tp, cfg, tokens)
        pools = M.init_paged_state(cfg, 8, 4, mesh=m)
        out[name] = {"logits": spmd.full(lg),
                     "prefill": prefill_logits(tp, cfg, tokens, m),
                     "pools": [{k: port_spec(v) for k, v in p.items()}
                               for p in pools]}
    for name, (x, w, axes) in gemms.items():
        wt = S.place_tree(w, axes, m, rules)
        with C.sharding_context(m, rules):
            y = ops.bnn_dense(C.lsc(x, "batch", None), wt["w"],
                              precision="bnn")
        out[name] = {"out": spmd.full(y), "spec": port_spec(wt["w"])}
    return out


# --------------------------------------------------------------- slots


def pools_agree(pools, mesh) -> bool:
    """Every data rank holds the same slices of every pool (gathered
    over ``data`` and compared)."""
    from repro_torch.dist import spmd
    i = mesh.mesh_dim_names.index("data")
    if mesh.size(i) == 1:
        return True
    for pool in pools:
        for v in pool.values():
            parts = spmd.all_gather(spmd.local(v)[None], mesh, i, 0)
            if not all(torch.equal(q, parts[0]) for q in parts):
                return False
    return True


def watch_slot_swaps(eng) -> list:
    """Record each swapped slot's state (the rank's slices) at swap-out
    and append, at its swap-in, whether it came back bit-equal."""
    from repro_torch.dist import spmd
    ssm, saved, same = eng.cache.ssm, {}, []
    swap_out, swap_in = ssm.swap_out, ssm.swap_in

    def out(req, peer=None):
        saved[req.rid] = [{k: spmd.local(v)[req.slot].clone()
                           for k, v in p.items()} for p in ssm.pools]
        return swap_out(req, peer)

    def back(req):
        ok = swap_in(req)
        if ok and req.rid in saved:
            same.append(all(torch.equal(spmd.local(p[k])[req.slot], v)
                            for p, want in zip(ssm.pools,
                                               saved.pop(req.rid))
                            for k, v in want.items()))
        return ok
    ssm.swap_out, ssm.swap_in = out, back
    return same


def drive_slots(eng, prompts, max_new, preempt_after, sampling=None,
                each_step=None):
    """The first prompt served alone (its snapshots published), then the
    rest at once, the policy's victim preempted after ``preempt_after``
    steps of them; ``each_step(eng)`` after every step.  The tokens of
    each request, in prompt order."""
    def samp(i):
        return {"sampling": sampling(i)} if sampling else {}

    def step():
        eng.step()
        if each_step is not None:
            each_step(eng)
    rids = [eng.submit(prompts[0], max_new, **samp(0))]
    while not eng.scheduler.idle:
        step()
    rids += [eng.submit(p, max_new, **samp(i))
             for i, p in enumerate(prompts[1:], start=1)]
    for _ in range(preempt_after):
        step()
    eng.scheduler._preempt_one(eng.step_count, None)
    while not eng.scheduler.idle:
        step()
    return [eng.requests[r].full_sequence().tolist() for r in rids]


def slot_counts(st: dict) -> dict:
    """What the snapshot and swap machinery did in a run."""
    return {"snapshot_hits": st["prefix_cache"]["snapshot_hits"],
            "snapshot_stores": st["prefix_cache"]["snapshot_stores"],
            "preemptions": st["preemptions"],
            "swapped_slots": st["swap"]["swapped_slots"],
            "readopted_snapshots": st["swap"]["readopted_snapshots"]}


def slots_worker(world, arch, shapes, params, prompts, max_new,
                 preempt_after, ekw):
    """On each mesh of ``shapes`` the engine under the JAX engine's
    defaults (prefix cache: slot snapshots; swap) runs ``drive_slots``,
    greedy then sampled, the ranks' tokens compared at every step:
    the tokens, ``slot_counts``, whether every swapped slot came back
    bit-equal on this rank, and whether the data ranks' pools were equal
    after every step."""
    cfg = port_cfg(arch=arch)
    out = {}
    for shape in shapes:
        m = mesh(shape)
        runs = []
        for sampled in (False, True):
            eng = Engine(params, cfg, EngineConfig(**{**EKW, **ekw}),
                         device="cpu", mesh=m, check_ranks=True)
            same = watch_slot_swaps(eng)
            agree = []
            toks = drive_slots(
                eng, prompts, max_new, preempt_after,
                sampling("torch") if sampled else None,
                lambda e: agree.append(pools_agree(e.cache.pools, m)))
            runs.append({"tokens": toks, **slot_counts(eng.stats()),
                         "restored_equal": same, "pools_agree": agree})
        out[tuple(shape)] = runs
    return out


def spec_worker(world, shape, cases):
    """Over a ``shape`` mesh, for each case (name -> (arch, params,
    prompts, new tokens, engine kwargs)): the speculative engine
    (spec_k 3) serves the prompts, the ranks' tokens compared at every
    step: its tokens and speculative counts."""
    m = mesh(shape)
    out = {}
    for name, (arch, params, ps, gen, ekw) in cases.items():
        eng = Engine(params, port_cfg(arch=arch),
                     EngineConfig(**ekw, spec_k=3), device="cpu", mesh=m,
                     check_ranks=True)
        rids = [eng.submit(p, gen) for p in ps]
        got = eng.run()
        out[name] = {"tokens": [got[r].tolist() for r in rids],
                     "speculative": eng.stats()["speculative"]}
    return out


def jobs_worker(world, jobs):
    """Each job (a worker of this module, its arguments after ``world``)
    in turn on this rank, in one world: their results, in order."""
    return [fn(world, *args) for fn, args in jobs]


def drive_slots_jax(jcfg, jparams, prompts, max_new, preempt_after, ekw):
    """``drive_slots`` on one JAX ``Engine`` (the XLA paths, ``EKW``
    updated by ``ekw``), greedy then sampled: the tokens of each run."""
    from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
    return [drive_slots(JEngine(jparams, jcfg, JEngineConfig(
        **{**EKW, **ekw}, attn_impl="xla", bnn_impl="xla")), prompts,
        max_new, preempt_after, sampling("jax") if sampled else None)
        for sampled in (False, True)]


def drive_slots_port(cfg, params, prompts, max_new, preempt_after, ekw):
    """``drive_slots`` on the port's one-rank engine, greedy then
    sampled: (tokens, ``slot_counts``) of each run."""
    out = []
    for sampled in (False, True):
        eng = Engine(params, cfg, EngineConfig(**{**EKW, **ekw}),
                     device="cpu")
        toks = drive_slots(eng, prompts, max_new, preempt_after,
                           sampling("torch") if sampled else None)
        out.append((toks, slot_counts(eng.stats())))
    return out


def check_slots(ranks, shape, one, jax_tokens=None):
    """Every rank's ``slots_worker`` runs over ``shape``: the one-rank
    engine's tokens (and JAX's, where given), greedy and sampled;
    snapshots hit, a slot went to the host and came back bit-equal, the
    schedule's counts are one rank's, and the data ranks' pools agreed
    after every step."""
    for i in (0, 1):
        toks, counts = one[i]
        assert jax_tokens is None or toks == jax_tokens[i]
        assert counts["snapshot_hits"] > 0 and counts["swapped_slots"] >= 1
        for rank in ranks:
            run = rank[shape][i]
            assert run["tokens"] == toks
            assert {k: run[k] for k in counts} == counts
            assert run["restored_equal"] and all(run["restored_equal"])
            assert run["pools_agree"] and all(run["pools_agree"])


def frontend_worker(world, shapes, cases):
    """On each mesh of ``shapes``, for each case (name -> (arch, params,
    batch of numpy arrays: the stub front-ends' embeddings, any
    tokens)): ``logits_fn`` and the prefill step with the embeddings
    placed by batch, whole, and the logits' placements."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.launch import steps
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    out = {}
    for shape in shapes:
        m = mesh(shape)
        rules = S.rules_decode(False)
        for name, (arch, params, batch) in cases.items():
            cfg = port_cfg(arch=arch)
            tp = S.place_params(params, cfg, m)
            with C.sharding_context(m, rules), torch.no_grad():
                b = {k: (torch.from_numpy(v.astype(np.int64)) if k == "tokens"
                         else C.lsc(torch.from_numpy(v), "batch", None, None))
                     for k, v in batch.items()}
                lg = M.logits_fn(tp, cfg, b.get("tokens"),
                                 embeds=b.get("embeds"),
                                 prefix_embeds=b.get("prefix_embeds"))
                pre = steps.build_prefill_step(cfg)(tp, b)
            out[(tuple(shape), name)] = {
                "logits": spmd.full(lg), "prefill": spmd.full(pre),
                "placements": [str(p) for p in lg.placements]}
    return out


def init_worker(world, arch, shape):
    """``launch/mesh.init_on_ranks`` of the reduced ``arch`` (seed 0) over
    a ``shape`` mesh: every leaf's placement and the leaves gathered
    whole."""
    from repro_torch.dist import sharding as S
    from repro_torch.launch.mesh import init_on_ranks
    from repro_torch.models import transformer as M
    cfg = port_cfg(arch=arch)
    params = M.trainable(init_on_ranks(torch.Generator().manual_seed(0), cfg,
                                       mesh(shape)), cfg)
    return {"specs": {k: port_spec(v)
                      for k, v in flat_leaves(params).items()},
            "params": S.gather_tree(params)}
