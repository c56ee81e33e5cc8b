"""Shared pieces of the tests of the forward over several ranks
(tests/test_torch_ranks*.py): the reduced bnn-lm-100m at precision
"bnn", meshes of real ``gloo`` ranks on the CPU
(``launch/mesh.spawn_ranks``: one ``spawn`` of a world per test file
and world size, every mesh of that size built in it), and the rank
workers.  A worker is a module-level function of this module (the
ranks import it by name); it returns plain tensors and lists, whole on
every rank, and the tests compare what every rank returned.

Inputs are made from numpy seeds; the weights are the JAX package's
``init(PRNGKey(0))`` converted by ``interop.params_from_numpy``, handed
to the ranks whole: each rank keeps its slices (``place_params``)."""
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


def port_cfg(precision: str = "bnn"):
    return treduced(tconfigs.get_config(ARCH)).replace(precision=precision)


def mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))


def spawn(fn, size: int, *args):
    from repro_torch.launch.mesh import spawn_ranks
    return spawn_ranks(fn, size, *args, timeout_s=240.0)


def prompts(vocab: int, lens, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def sampling(pkg: str):
    """Request i's sampling parameters in either package (seeded by i)."""
    if pkg == "jax":
        from repro.serving import SamplingParams as P
    else:
        P = SamplingParams
    return lambda i: P(temperature=0.8, top_k=20, top_p=0.9, seed=100 + i)


# --------------------------------------------------------------- JAX mesh

JAX_MESH_LOGITS = textwrap.dedent('''
    import sys
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro import configs
    from repro.configs.base import reduced
    from repro.dist import sharding as S
    from repro.layers import common as C
    from repro.models import transformer as M
    cfg = reduced(configs.get_config("bnn-lm-100m")).replace(
        precision="bnn")
    params, specs = M.init(jax.random.PRNGKey(0), cfg)
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = S.rules_decode(False)
    params = jax.device_put(params, S.param_shardings(mesh, params, specs,
                                                      rules))
    tokens = np.load(sys.argv[1])
    with C.sharding_context(mesh, rules):
        logits = jax.jit(lambda p, t: M.logits_fn(p, cfg, {"tokens": t}))(
            params, tokens)
    np.save(sys.argv[2], np.asarray(logits))
    print("SPEC", tuple(logits.sharding.spec))
''')


def jax_mesh_logits(tokens: np.ndarray, tmp: Path) -> tuple[np.ndarray,
                                                             tuple]:
    """JAX's ``logits_fn`` under a 2x2 ``Mesh`` of 4 forced host devices
    and the decode rules, in a fresh process (the device count is fixed
    when JAX starts): (logits, their PartitionSpec as a tuple)."""
    src, dst = tmp / "tokens.npy", tmp / "logits.npy"
    np.save(src, tokens)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", JAX_MESH_LOGITS, str(src),
                          str(dst)], capture_output=True, text=True,
                         env=env, timeout=240)
    assert res.returncode == 0, res.stderr
    spec = res.stdout.split("SPEC ")[1].strip()
    return np.load(dst), eval(spec, {"__builtins__": {}})


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


def forward_worker(world, shapes, params, tokens, n_new):
    """On each mesh of ``shapes``: ``logits_fn`` over ``tokens`` (its
    placements and the logits whole), ``build_prefill_step``'s logits,
    ``build_decode_step`` fed the prompt a token a step over the legacy
    caches, then ``n_new`` greedy tokens, and the serve CLI's paged and
    legacy runs over the mesh (``tokens`` the prompts, ``n_new`` new)."""
    from repro_torch.dist import sharding as S, spmd
    from repro_torch.launch import serve as SV, steps
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    cfg = port_cfg()
    rules = S.rules_decode(False)
    tok = torch.from_numpy(tokens.astype(np.int64))
    b, t = tok.shape
    out = {}
    for shape in shapes:
        m = mesh(shape)
        tp = S.place_params(params, cfg, m)
        dec = steps.build_decode_step(cfg)
        caches = M.init_cache(cfg, b, t + n_new, mesh=m)
        with C.sharding_context(m, rules):
            lg = M.logits_fn(tp, cfg, tok)
            pre = steps.build_prefill_step(cfg)(tp, {"tokens": tok})
            cur, seq = tok[:, :1], [tok[:, :1]]
            for i in range(t + n_new - 1):
                nxt, caches = dec(tp, caches, {"tokens": cur, "length": i})
                cur = tok[:, i + 1:i + 2] if i + 1 < t else \
                    nxt[:, None].long()
                seq.append(cur)
        out[tuple(shape)] = {
            "logits": spmd.full(lg),
            "placements": [str(p) for p in lg.placements],
            "prefill": spmd.full(pre),
            "decode": torch.cat(seq, dim=1),
            "serve": {engine: SV.serve(
                ARCH, smoke=True, precision="bnn", gen=n_new, device="cpu",
                engine=engine, params=params, prompts=tokens, mesh=m,
                verbose=False) for engine in ("paged", "legacy")}}
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


def engine_worker(world, shapes, params, ps, max_new, ekw):
    """On each mesh of ``shapes`` the engine (``serve``'s ``ekw``)
    serves ``ps`` greedy, then sampled, with the ranks' tokens compared
    at every step (``check_ranks``); the tokens, and what the schedule
    did."""
    from repro_torch.kernels import ops
    cfg = port_cfg()
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
                         "prefix_hits": st["prefix_cache"]["hits"]})
        out[tuple(shape)] = runs
    return out
