"""Multi-pod dry-run: place every (arch x shape x mesh) cell.

Shows that the partitioning plan is coherent without the devices:
under a fake process group of 256 or 512 ranks (``launch/mesh.py``),
every leaf a step takes is placed on the 16x16 single-pod mesh and the
2x16x16 multi-pod mesh as a ``meta`` DTensor, by the train rules (FSDP)
or the decode rules (``dist/sharding.py``): the params at bf16, the
AdamW moments of a train cell (bf16 at ``d_model >= 4096``), the caches
of a decode cell, the batch.  Per cell and per device it records the
argument bytes (the counterpart of XLA's ``memory_analysis``), the
analytic model's FLOPs and HBM bytes (``launch/analytic.py``) and its
roofline terms, and every leaf's partition spec, into a JSON artifact.

The JAX package's dry-run compiles each cell and reads its collectives
from the optimized HLO; torch makes no HLO, and the dry-run places
tensors without running a step, so ``"collectives"`` is null (with the
reason) and the roofline takes no collective bytes.  (The serving
forward does run over several ranks, ``dist/spmd.py``; counting a
step's collectives here is ROADMAP.md queue 1, item 11c.)

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
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.dist import sharding as S
from repro_torch.launch import analytic, steps as steps_mod
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     n_devices)
from repro_torch.layers.common import logical_to_pspec, to_placements
from repro_torch.models import transformer as M
from repro_torch.optim import optimizer as opt_mod

NO_COLLECTIVES = ("no HLO to read collectives from; the dry-run's "
                  "collective counts come with ROADMAP.md queue 1, item "
                  "11's dry-run part")


class Placer:
    """``meta`` DTensors on one mesh: one is made for each distinct
    (shape, dtype, placements), and leaves alike share it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._made: dict = {}

    def place(self, t: torch.Tensor, spec: tuple):
        """The DTensor of ``t`` (a meta tensor) under partition spec
        ``spec`` (``logical_to_pspec``)."""
        from torch.distributed.tensor import distribute_tensor
        placements = to_placements(spec, self.mesh)
        key = (tuple(t.shape), t.dtype, tuple(map(repr, placements)))
        if key not in self._made:
            self._made[key] = distribute_tensor(
                torch.empty(t.shape, dtype=t.dtype, device="meta"),
                self.mesh, placements, src_data_rank=None)
        return self._made[key]

    def local_bytes(self, t: torch.Tensor, spec: tuple) -> int:
        """Bytes of this device's shard of ``t``."""
        local = self.place(t, spec).to_local()
        return local.numel() * local.element_size()


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


def place(placer: Placer, specs, tree, rules) -> tuple[int, dict]:
    """(this device's bytes, {path: partition spec}) of ``tree`` placed
    by ``rules``."""
    total, pspecs = 0, {}
    for path, axes, leaf in _walk(specs, tree):
        spec = logical_to_pspec(tuple(axes), rules, tuple(leaf.shape),
                                placer.mesh)
        total += placer.local_bytes(leaf, spec)
        pspecs[path] = jsonable(spec)
    return total, pspecs


def param_tree(cfg):
    """(bf16 ``meta`` params, their specs): the trainable tree, a tied
    head counted once."""
    params = M.trainable(M.abstract_init(cfg), cfg)
    return steps_mod.to_dtype_structs(params, torch.bfloat16), \
        M.param_specs(cfg)


def run_cell(arch: str, shape: str, multi_pod: bool, *, mesh=None,
             microbatches: int = 8, overrides: dict | None = None,
             trees: dict | None = None) -> dict:
    """Place one cell on ``mesh`` (default: the production mesh, which
    needs a process group of its size) and return its record.
    ``trees``, when a dict, keeps ``param_tree``'s result by config
    across the cells of a sweep."""
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped",
                "reason": "full-attention arch; long_500k needs "
                          "sub-quadratic attention"}
    t0 = time.perf_counter()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    placer = Placer(mesh)
    kind = cell.kind
    rules = (S.rules_decode(multi_pod) if kind == "decode"
             else S.rules_train(multi_pod, fsdp=(kind == "train")))

    if trees is None:
        params, specs = param_tree(cfg)
    else:
        if cfg not in trees:
            trees[cfg] = param_tree(cfg)
        params, specs = trees[cfg]
    mem = {}
    mem["params_bytes"], pspecs_p = place(placer, specs, params, rules)
    bspec = steps_mod.input_specs(cfg, cell)
    mem["batch_bytes"], pspecs_b = place(
        placer, {k: S.batch_axes(v.ndim) for k, v in bspec.items()}, bspec,
        rules)
    record = {"params": pspecs_p, "batch": pspecs_b}
    if kind == "train":
        opt_cfg = opt_mod.AdamWConfig(
            moment_dtype=torch.bfloat16 if cfg.d_model >= 4096
            else torch.float32)
        state = opt_mod.abstract_state(opt_cfg, params)
        mem["opt_state_bytes"], _ = place(
            placer, opt_mod.state_specs(specs), state, rules)
        mem["moment_dtype"] = str(opt_cfg.moment_dtype)
    elif kind == "decode":
        caches = steps_mod.cache_specs_abstract(cfg, cell)
        mem["cache_bytes"], record["cache"] = place(
            placer, M.cache_specs(cfg), caches, rules)
    mem["argument_size_in_bytes"] = sum(
        v for k, v in mem.items() if k.endswith("_bytes"))
    t_place = time.perf_counter() - t0

    cm = analytic.cell_model(cfg, cell, microbatches=microbatches)
    return {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "status": "ok", "kind": kind, "devices": n_dev,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "place_s": round(t_place, 3),
        "memory": mem,
        "analytic": {
            "flops_fwd": cm.flops_fwd, "flops_total": cm.flops_total,
            "hbm_bytes": cm.hbm_bytes, "model_flops": cm.model_flops,
            "params_total": cm.params_total,
            "params_active": cm.params_active,
            "flops_per_device": cm.flops_total / n_dev,
            "hbm_bytes_per_device": cm.hbm_bytes / n_dev,
            **cm.notes},
        "roofline": analytic.roofline_terms(cm, 0.0, n_dev),
        "collectives": None,
        "collectives_reason": NO_COLLECTIVES,
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
                    extra = (f" flops/dev={res['analytic']['flops_per_device']:.3e}"
                             f" hbm/dev={res['analytic']['hbm_bytes_per_device']:.3e}B"
                             f" args/dev={res['memory']['argument_size_in_bytes']}B"
                             f" place={res['place_s']}s")
                print(f"[{status}] {tag}{extra}", flush=True)
    print(f"[dryrun] ok={counts['ok']} skipped={counts['skipped']} "
          f"error={counts['error']} cached={counts['cached']}")
    if counts["error"]:
        raise SystemExit(f"{counts['error']} cells failed")


if __name__ == "__main__":
    main()
