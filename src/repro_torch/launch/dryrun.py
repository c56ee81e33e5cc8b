"""Multi-pod dry-run: place and step every (arch x shape x mesh) cell.

Shows that the partitioning plan is coherent without the devices:
under a fake process group of 256 or 512 ranks (``launch/mesh.py``),
every leaf a step takes is placed on the 16x16 single-pod mesh and the
2x16x16 multi-pod mesh by the train rules (FSDP) or the decode rules
(``dist/sharding.py``): the params at bf16, the AdamW moments of a
train cell (bf16 at ``d_model >= 4096``), the caches of a decode cell,
the batch.  Then the cell's own step runs on rank 0's ``meta`` shards
of them (``step_run``: ``build_train_step`` with 8 microbatches and
remat and the AdamW update, ``build_prefill_step``,
``build_decode_step``): nothing is computed or allocated, and rank 0
issues every collective a rank issues.  Per cell and per device it
records, into a JSON artifact:
  * ``collectives``: the step's schedule with the keys and byte meaning
    of the JAX package's ``analyze_collectives`` (its HLO read from the
    compiled step; here ``launch/collectives.py`` from the step's own
    collectives, scaled to the whole depth), and ``sent``, the calls
    and bytes a rank sends in (``dist/spmd.COLLECTIVES``' meaning);
  * ``first_call``: what a serving step's first call gathers into the
    per-weight caches beyond the steady step (an SSM layer's whole
    pieces, MLA's up projections), and the bytes cached;
  * ``memory``: the keys of JAX's ``memory_summary`` (argument, output,
    alias, temp; generated code has no counterpart, and the record says
    why) beside the argument bytes by part;
  * the analytic model's FLOPs and HBM bytes (``launch/analytic.py``)
    and its roofline terms, the collective term from the step's
    executed bytes;
  * every leaf's partition spec.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out DIR]

``--all`` sweeps every arch of ``ARCH_IDS`` over every shape cell; a
full-attention arch records ``long_500k`` as skipped (the cells
``cells_for`` leaves out), as the JAX package's sweep does.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs, tree as T
from repro_torch.configs.base import SHAPES
from repro_torch.dist import sharding as S, spmd
from repro_torch.kernels import ops as kops
from repro_torch.launch import analytic, collectives as coll, \
    mesh as MESH, steps as steps_mod
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     n_devices)
from repro_torch.layers import common as C
from repro_torch.layers.common import logical_to_pspec, to_placements
from repro_torch.models import transformer as M
from repro_torch.optim import optimizer as opt_mod

def local_shape(shape, placements, mesh) -> list[int]:
    """A rank's shard's shape of a tensor of ``shape`` placed by
    ``placements`` on ``mesh`` (every cut divides:
    ``logical_to_pspec``)."""
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return local


def _walk(specs, tree, path=""):
    """(path, logical axes, leaf) over a spec tree and the tree shaped
    as it."""
    if S.is_axes(specs):
        yield path, specs, tree
    elif isinstance(specs, dict):
        for k in specs:
            yield from _walk(specs[k], tree[k], f"{path}.{k}" if path else k)
    else:
        for i, v in enumerate(specs):
            yield from _walk(v, tree[i], f"{path}.{i}" if path else str(i))


def jsonable(spec: tuple) -> list:
    """A partition spec as JSON: per dim a mesh-axis name, a list of
    them, or null."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def place(mesh, specs, tree, rules) -> tuple[int, dict]:
    """(this device's bytes, {path: partition spec}) of ``tree`` placed
    on ``mesh`` by ``rules``."""
    total, pspecs = 0, {}
    for path, axes, leaf in _walk(specs, tree):
        spec = logical_to_pspec(tuple(axes), rules, tuple(leaf.shape), mesh)
        total += math.prod(local_shape(leaf.shape, to_placements(spec, mesh),
                                       mesh)) * leaf.element_size()
        pspecs[path] = jsonable(spec)
    return total, pspecs


def param_tree(cfg, dtype=torch.bfloat16, trees: dict | None = None):
    """(``meta`` params at ``dtype``, their specs): the trainable tree, a
    tied head counted once; kept in ``trees`` by (config, dtype) where
    it is a dict."""
    if trees is not None and (cfg, dtype) in trees:
        return trees[(cfg, dtype)]
    params = M.trainable(M.abstract_init(cfg), cfg)
    out = steps_mod.to_dtype_structs(params, dtype), M.param_specs(cfg)
    if trees is not None:
        trees[(cfg, dtype)] = out
    return out


def shard_tree(mesh, specs, tree, rules):
    """``tree``'s leaves as ``meta`` DTensors placed by ``rules``, each
    leaf its own: the per-weight caches key on a tensor's identity, so
    leaves alike must not share one (and a step's cache entries go with
    its tensors, ``kernels/ops.cached_per_weight``)."""
    def one(axes, t):
        pl = to_placements(logical_to_pspec(tuple(axes), rules,
                                            tuple(t.shape), mesh), mesh)
        return spmd.wrap(torch.empty(local_shape(t.shape, pl, mesh),
                                     dtype=t.dtype, device="meta"),
                         mesh, pl, t.shape)
    return S.map_specs(one, specs, tree)


def _call(step, args, **tags) -> dict:
    """One call of ``step(*args)``: its collectives (``spmd.recording``)
    and its memory (``collectives.LiveBytes``): the peak of the bytes it
    allocates ("temp"), its outputs' and, of those, the ones that are
    arguments updated in place ("alias")."""
    held = coll.storages(args)
    with spmd.recording() as events, spmd.tagged(**tags), \
            coll.LiveBytes() as live:
        out = step(*args)
    got = coll.storages(out)
    return {"events": events, "temp": live.peak, "peaks": live.peaks,
            "output": sum(got.values()),
            "alias": sum(n for k, n in got.items() if k in held)}


def step_run(cfg, cell, mesh, rules, microbatches: int, dtype,
             trees: dict | None = None) -> dict:
    """One call of the cell's step on one rank's ``meta`` shards of
    ``cfg``'s params (at ``cfg``'s depth), as ``_call`` returns it, and
    what the per-weight caches hold after it ("cached_bytes"): a train
    cell's ``build_train_step`` (remat on) over two microbatches of the
    cell's (its rows split ``microbatches`` ways; one where it is not
    split), then the AdamW update on the placed moments; a prefill
    cell's ``build_prefill_step``; a decode cell's ``build_decode_step``
    with the cache filled to ``seq_len - 1``, over the caches placed as
    the port places them (``sharding.state_rules_of``).  The serving
    steps' collectives carry ``microbatch=0``: their forward is the one
    pass over the layers.  ``trees`` as ``param_tree``'s."""
    params, specs = param_tree(cfg, dtype, trees)
    p = shard_tree(mesh, specs, params, rules)
    if cfg.tie_embeddings:
        p["head"] = {"w": spmd.transpose(p["embed"]["w"])}
    batch = steps_mod.input_specs(cfg, cell, compute_dtype=dtype)
    with C.sharding_context(mesh, rules):
        if cell.kind == "train":
            g = min(microbatches, 2)
            rows = cell.global_batch // microbatches * g
            opt_cfg = moment_config(cfg)
            state = opt_mod.abstract_state(opt_cfg, params)
            state = {"m": shard_tree(mesh, specs, state["m"], rules),
                     "v": shard_tree(mesh, specs, state["v"], rules),
                     "step": state["step"]}
            run = _call(steps_mod.build_train_step(cfg, opt_cfg,
                                                   microbatches=g),
                        (p, state, {k: v[:rows] for k, v in batch.items()}))
        elif cell.kind == "prefill":
            run = _call(steps_mod.build_prefill_step(cfg), (p, batch),
                        microbatch=0)
        else:
            caches = shard_tree(
                mesh, M.cache_specs(cfg),
                steps_mod.cache_specs_abstract(cfg, cell, dtype),
                S.state_rules_of(mesh))
            run = _call(steps_mod.build_decode_step(cfg), (
                p, caches, {"tokens": batch["tokens"],
                            "length": cell.seq_len - 1}), microbatch=0)
    run["cached_bytes"] = kops.cached_bytes(MESH.CACHED_KINDS, T.leaves(p))
    return run


def moment_config(cfg) -> opt_mod.AdamWConfig:
    """The JAX dry-run's AdamW: bf16 moments from ``d_model`` 4096 on,
    else float32."""
    return opt_mod.AdamWConfig(
        moment_dtype=torch.bfloat16 if cfg.d_model >= 4096
        else torch.float32)


def step_record(cfg, cell, mesh, rules, microbatches: int, dtype,
                trees: dict | None = None) -> dict:
    """The step's collective record and memory at ``cfg``'s whole depth,
    scaled from runs at a and a + 1 periods of its scan segment
    (``collectives.scale``: a = 1, or 2 where one period is one layer
    and the depth has more), and apart from them ("first_call")
    what the per-weight caches gather at their first use, and hold."""
    segs = M.segments(cfg)
    period, periods = len(segs[-1][1]), segs[-1][2]
    # a depth of one layer peaks apart from the deeper ones
    a = 2 if periods > 2 and cfg.first_dense + period < 2 else 1
    runs = [step_run(cfg.replace(n_layers=cfg.first_dense + k * period),
                     cell, mesh, rules, microbatches, dtype, trees)
            for k in ((a, a + 1) if periods > 1 else (1,))]
    firsts = []
    for r in runs:
        firsts.append({"events": [e for e in r["events"]
                                  if ("first_use", True) in e[3]]})
        r["events"] = [e for e in r["events"]
                       if ("first_use", True) not in e[3]]
    trips = microbatches if cell.kind == "train" else 1
    entries, mem = coll.scale(runs[0], runs[-1], a, periods, trips)
    once, _ = coll.scale(firsts[0], firsts[-1], a, periods, 1)
    return {"collectives": coll.analyze(entries),
            "sent": coll.sent_totals(entries), "memory": mem,
            "first_call": {"sent": coll.sent_totals(once),
                           "cached_bytes": coll.affine(
                               runs[0]["cached_bytes"],
                               runs[-1]["cached_bytes"], a, periods)}}


def run_cell(arch: str, shape, multi_pod: bool, *, mesh=None,
             microbatches: int = 8, overrides: dict | None = None,
             trees: dict | None = None, dtype=torch.bfloat16) -> dict:
    """Place one cell on ``mesh`` (default: the production mesh, which
    needs a process group of its size), run its step on this rank's
    ``meta`` shards, and return its record.  ``shape`` is a name of
    ``SHAPES`` or a ``ShapeCell``; ``dtype`` the params' (and the
    activations'); ``trees``, when a dict, keeps ``param_tree``'s
    result by config across the cells of a sweep."""
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return {"arch": arch, "shape": cell.name, "multi_pod": multi_pod,
                "status": "skipped",
                "reason": "full-attention arch; long_500k needs "
                          "sub-quadratic attention"}
    t0 = time.perf_counter()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    kind = cell.kind
    rules = (S.rules_decode(multi_pod) if kind == "decode"
             else S.rules_train(multi_pod, fsdp=(kind == "train")))

    params, specs = param_tree(cfg, dtype, trees)
    mem = {}
    mem["params_bytes"], pspecs_p = place(mesh, specs, params, rules)
    bspec = steps_mod.input_specs(cfg, cell, compute_dtype=dtype)
    mem["batch_bytes"], pspecs_b = place(
        mesh, {k: S.batch_axes(v.ndim) for k, v in bspec.items()}, bspec,
        rules)
    record = {"params": pspecs_p, "batch": pspecs_b}
    if kind == "train":
        opt_cfg = moment_config(cfg)
        state = opt_mod.abstract_state(opt_cfg, params)
        mem["opt_state_bytes"], _ = place(
            mesh, opt_mod.state_specs(specs), state, rules)
        mem["moment_dtype"] = str(opt_cfg.moment_dtype)
    elif kind == "decode":
        caches = steps_mod.cache_specs_abstract(cfg, cell, dtype)
        mem["cache_bytes"], record["cache"] = place(
            mesh, M.cache_specs(cfg), caches, rules)
        # the caches as the port's decode step holds them
        mem["step_cache_bytes"], _ = place(mesh, M.cache_specs(cfg), caches,
                                           S.state_rules_of(mesh))
    mem["argument_size_in_bytes"] = sum(
        v for k, v in mem.items() if k.endswith("_bytes")
        and k != "cache_bytes")
    t_place = time.perf_counter() - t0

    step = step_record(cfg, cell, mesh, rules, microbatches, dtype, trees)
    mem["output_size_in_bytes"] = step["memory"]["output"]
    mem["alias_size_in_bytes"] = step["memory"]["alias"]
    mem["temp_size_in_bytes"] = step["memory"]["temp"]
    mem["generated_code_size_omitted"] = coll.NO_GENERATED_CODE
    t_step = time.perf_counter() - t0 - t_place

    cm = analytic.cell_model(cfg, cell, microbatches=microbatches)
    return {
        "arch": arch, "shape": cell.name, "multi_pod": multi_pod,
        "status": "ok", "kind": kind, "devices": n_dev,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "place_s": round(t_place, 3), "step_s": round(t_step, 3),
        "memory": mem,
        "analytic": {
            "flops_fwd": cm.flops_fwd, "flops_total": cm.flops_total,
            "hbm_bytes": cm.hbm_bytes, "model_flops": cm.model_flops,
            "params_total": cm.params_total,
            "params_active": cm.params_active,
            "flops_per_device": cm.flops_total / n_dev,
            "hbm_bytes_per_device": cm.hbm_bytes / n_dev,
            **cm.notes},
        "roofline": analytic.roofline_terms(
            cm, step["collectives"]["total_bytes_executed"], n_dev),
        "collectives": step["collectives"],
        "sent": step["sent"],
        "first_call": step["first_call"],
        "pspecs": record,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        jobs = [(a, s) for a in configs.ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        jobs = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    counts = {"ok": 0, "skipped": 0, "error": 0, "cached": 0}
    trees: dict = {}
    for mp in meshes:
        with fake_world(n_devices(mp)):
            mesh = make_production_mesh(multi_pod=mp)
            for arch, shape in jobs:
                tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    counts["cached"] += 1
                    print(f"[skip-cached] {tag}")
                    continue
                try:
                    res = run_cell(arch, shape, mp, mesh=mesh,
                                   microbatches=args.microbatches,
                                   trees=trees)
                except Exception as e:  # recorded, the sweep goes on
                    res = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()}
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                status = res["status"]
                counts[status] += 1
                extra = ""
                if status == "ok":
                    mem = res["memory"]
                    extra = (f" flops/dev={res['analytic']['flops_per_device']:.3e}"
                             f" coll={res['collectives']['total_bytes_executed']:.3e}B"
                             f" args/dev={mem['argument_size_in_bytes']}B"
                             f" temp/dev={mem['temp_size_in_bytes']}B"
                             f" {res['roofline']['dominant']}"
                             f" step={res['step_s']}s")
                print(f"[{status}] {tag}{extra}", flush=True)
    print(f"[dryrun] ok={counts['ok']} skipped={counts['skipped']} "
          f"error={counts['error']} cached={counts['cached']}")
    if counts["error"]:
        raise SystemExit(f"{counts['error']} cells failed")


if __name__ == "__main__":
    main()
