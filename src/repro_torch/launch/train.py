"""Training launcher: the port's counterpart of the JAX package's
``repro.launch.train`` — the train step, the synthetic data stream and
the checkpoint/restore loop on one device.

  * CPU (tests):  --smoke --device cpu  (the reduced config)
  * the card:     the default; ``train()`` without a card raises

Resume-from-latest is automatic when ``--ckpt-dir`` holds a committed
checkpoint.  The parameters start from the port's own torch init
(``M.init`` from a generator seeded ``seed``), or from ``params``
(tests hand over weights carried across from the JAX package); they are
trained in place.  The step runs on one device: the option of a later
slice (``--multi-pod``: training over several ranks, under FSDP)
raises and names its ROADMAP.md item.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch bnn-lm-100m \\
      --steps 50 --ckpt-dir checkpoints/bnn-lm-100m
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_tensors
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as M
from repro_torch.optim import optimizer as opt_mod
from repro_torch.serving.engine import _resolve_device

# options of the JAX CLI that later slices bring: argument -> (its
# default, the ROADMAP.md item that brings it)
LATER = {
    "multi_pod": (False, "queue 1, item 11b"),
}


def refuse_later(**opts):
    """Raise for any option of a later slice that is not at its default."""
    for name, value in opts.items():
        default, item = LATER[name]
        if value != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')}={value!r} is not ported yet "
                f"(ROADMAP.md {item})")


def train_init(cfg, device=None, seed: int = 0) -> dict:
    """The port's torch init of ``cfg`` from a generator seeded
    ``seed`` on ``device`` (``None``: the card, which must be there):
    the params ``train`` starts from by default."""
    dev = _resolve_device(device, "train")
    return M.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                  device=dev)


def adamw_config(lr: float, total: int) -> opt_mod.AdamWConfig:
    """AdamW as ``train`` runs it: peak ``lr``, a linear warm-up over
    the first tenth of ``total`` steps (at least one), then cosine."""
    return opt_mod.AdamWConfig(lr_peak=lr, warmup_steps=max(total // 10, 1),
                               total_steps=total)


def train(arch: str, *, smoke: bool = False, multi_pod: bool = False,
          steps: int = 50, global_batch: int = 8, seq_len: int = 128,
          microbatches: int = 1, ckpt_dir: str | None = None,
          ckpt_every: int = 20, lr: float = 3e-4, log_every: int = 10,
          precision: str | None = None, seed: int = 0,
          schedule_total: int | None = None, device=None, params=None,
          step_ms: list | None = None) -> list[float]:
    """Train ``arch`` for ``steps`` steps (from the latest checkpoint in
    ``ckpt_dir`` when there is one); returns the losses of the steps
    run.  A ``step_ms`` list receives each step's wall ms: from the
    read of the last step's loss to the read of this one's (a read
    waits for the device), the batch's build and copy included."""
    refuse_later(multi_pod=multi_pod)
    dev = _resolve_device(device, "train")
    cfg = configs.get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    if precision:
        cfg = cfg.replace(precision=precision)
    if params is None:
        params = train_init(cfg, dev, seed)
    total = schedule_total or steps
    opt_cfg = adamw_config(lr, total)
    tree = M.trainable(params, cfg)
    opt_state = opt_mod.init(opt_cfg, tree)

    data = SyntheticLM(DataConfig(cfg.vocab, seq_len, global_batch,
                                  seed=seed))
    step_fn = steps_mod.build_train_step(
        cfg, opt_cfg, microbatches=microbatches,
        loss_chunk=min(512, seq_len))

    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        (saved, opt_state), start = mgr.restore((tree, opt_state))
        with torch.no_grad():
            for p, s in zip(T.leaves(tree), T.leaves(saved), strict=True):
                p.copy_(s)
        print(f"[train] resumed from step {start}")

    losses = []
    t0 = mark = time.perf_counter()
    for step in range(start, steps):
        batch = to_tensors(data.batch(step), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        now = time.perf_counter()
        if step_ms is not None:
            step_ms.append((now - mark) * 1e3)
        mark = now
        if step % log_every == 0 or step == steps - 1:
            dt = now - t0
            print(f"[train] step={step:5d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt:.1f}s)", flush=True)
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
