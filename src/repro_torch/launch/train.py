"""Training launcher: the port's counterpart of the JAX package's
``repro.launch.train`` — the mesh, the train step, the synthetic data
stream and the checkpoint/restore loop.

  * CPU (tests):  --smoke --device cpu  (one device, the reduced config)
  * the card:     the default; ``train()`` without a card raises
  * production:   under a process group of 256 ranks the (16, 16) mesh,
                  with --multi-pod 512 ranks and (2, 16, 16), FSDP

As in the JAX launcher, a smoke run trains on one device and any other
run under a process group (or one asked for ``multi_pod``) over the
production mesh (``launch/mesh.launch_mesh``: it raises unless the
group has that many ranks); ``train(mesh=...)`` trains over any mesh
of the group (the tests' (2, 2) and (1, 4) of gloo ranks).  Over a
mesh the params are placed by the FSDP train rules
(``sharding.train_rules_of``: the JAX launcher's ``rules_train(
multi_pod, fsdp=True)``), every rank draws the same ``SyntheticLM``
batch, whole, and the step keeps its rows (``launch/steps``).

Resume-from-latest is automatic when ``--ckpt-dir`` holds a committed
checkpoint (over a mesh one rank writes it whole and every rank
restores its slices).  The parameters start from the port's own torch
init (``M.init`` from a generator seeded ``seed``; over a mesh each
rank keeps its slices, ``launch/mesh.init_on_ranks``), or from
``params`` (tests hand over weights carried across from the JAX
package, whole or placed; the config takes their depth); they are
trained in place.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch bnn-lm-100m \\
      --steps 50 --ckpt-dir checkpoints/bnn-lm-100m
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch import configs, tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_tensors
from repro_torch.dist import sharding as S, spmd
from repro_torch.launch import mesh as MESH, steps as steps_mod
from repro_torch.layers import common as C
from repro_torch.models import transformer as M
from repro_torch.optim import optimizer as opt_mod
from repro_torch.serving.engine import _resolve_device


def train_init(cfg, device=None, seed: int = 0, mesh=None) -> dict:
    """The port's torch init of ``cfg`` from a generator seeded
    ``seed`` on ``device`` (``None``: the card, which must be there):
    the params ``train`` starts from by default; over ``mesh`` placed
    by its FSDP train rules, each rank keeping its slices."""
    dev = _resolve_device(device, "train")
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        return M.init(gen, cfg, device=dev)
    return MESH.init_on_ranks(gen, cfg, mesh, device=dev,
                              rules=S.train_rules_of(mesh))


def adamw_config(lr: float, total: int) -> opt_mod.AdamWConfig:
    """AdamW as ``train`` runs it: peak ``lr``, a linear warm-up over
    the first tenth of ``total`` steps (at least one), then cosine."""
    return opt_mod.AdamWConfig(lr_peak=lr, warmup_steps=max(total // 10, 1),
                               total_steps=total)


def _restore_into(tree, saved):
    """The restored leaves (placed as ``tree``'s) written into ``tree``'s
    in place."""
    with torch.no_grad():
        for p, s in zip(T.leaves(tree), T.leaves(saved), strict=True):
            spmd.local(p).copy_(spmd.local(s))
            if spmd.is_dtensor(p):
                torch.autograd.graph.increment_version(p)


def train(arch: str, *, smoke: bool = False, multi_pod: bool = False,
          steps: int = 50, global_batch: int = 8, seq_len: int = 128,
          microbatches: int = 1, ckpt_dir: str | None = None,
          ckpt_every: int = 20, lr: float = 3e-4, log_every: int = 10,
          precision: str | None = None, seed: int = 0,
          schedule_total: int | None = None, device=None, params=None,
          mesh=None, step_ms: list | None = None,
          metrics: list | None = None) -> list[float]:
    """Train ``arch`` for ``steps`` steps (from the latest checkpoint in
    ``ckpt_dir`` when there is one); returns the losses of the steps
    run.  ``mesh``: as ``launch/mesh.launch_mesh`` (module docstring).
    A ``step_ms`` list receives each step's wall ms: from the read of
    the last step's loss to the read of this one's (a read waits for
    the device), the batch's build and copy included; a ``metrics``
    list each step's {"loss", "grad_norm", "lr"} as floats."""
    dev = _resolve_device(device, "train")
    cfg = configs.get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    if precision:
        cfg = cfg.replace(precision=precision)
    mesh = MESH.launch_mesh(smoke=smoke, multi_pod=multi_pod, device=dev,
                            mesh=mesh)
    rules = S.train_rules_of(mesh) if mesh is not None else None
    if params is None:
        params = train_init(cfg, dev, seed, mesh)
    else:
        # the given params' depth (a cut of the config's)
        cfg = cfg.replace(n_layers=len(params["layers"]))
        if mesh is not None:
            params = S.placed(params, cfg, mesh, rules)
    total = schedule_total or steps
    opt_cfg = adamw_config(lr, total)
    tree = M.trainable(params, cfg)
    opt_state = opt_mod.init(opt_cfg, tree)
    lead = mesh is None or all(c == 0 for c in mesh.get_coordinate())

    data = SyntheticLM(DataConfig(cfg.vocab, seq_len, global_batch,
                                  seed=seed))
    step_fn = steps_mod.build_train_step(
        cfg, opt_cfg, microbatches=microbatches,
        loss_chunk=min(512, seq_len))

    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        (saved, opt_state), start = mgr.restore((tree, opt_state))
        _restore_into(tree, saved)
        if lead:
            print(f"[train] resumed from step {start}")

    losses = []
    ctx = (C.sharding_context(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    t0 = mark = time.perf_counter()
    with ctx:
        for step in range(start, steps):
            batch = to_tensors(data.batch(step), dev)
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(float(m["loss"]))
            now = time.perf_counter()
            if step_ms is not None:
                step_ms.append((now - mark) * 1e3)
            if metrics is not None:
                metrics.append({k: float(v) for k, v in m.items()})
            mark = now
            if lead and (step % log_every == 0 or step == steps - 1):
                print(f"[train] step={step:5d} loss={losses[-1]:.4f} "
                      f"lr={float(m['lr']):.2e} "
                      f"gnorm={float(m['grad_norm']):.3f} "
                      f"({now - t0:.1f}s)", flush=True)
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, (tree, opt_state))
    if mgr:
        mgr.save(steps, (tree, opt_state))
        mgr.wait()
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bnn-lm-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch versions on the CPU "
                         "(default: the card)")
    args = ap.parse_args(argv)
    train(args.arch, smoke=args.smoke, multi_pod=args.multi_pod,
          steps=args.steps, global_batch=args.global_batch,
          seq_len=args.seq_len, microbatches=args.microbatches,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr,
          precision=args.precision, device=args.device)


if __name__ == "__main__":
    main()
