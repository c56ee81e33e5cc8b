"""End-to-end driver for the PyTorch/CUDA port: train the ~100M-parameter
BNN LM (every projection binarization-aware through the STE path) on
synthetic Markov data with checkpointing, then greedy-decode from the
trained weights in packed-XNOR inference mode through the Hopper
kernels — the flow of examples/train_bnn_lm.py, on the card.

The data stream has next-token entropy log(8) ~= 2.08 nats (vocab 32k ->
uniform loss ~10.4), so the loss signal is unambiguous.  ``--smoke``
trains the reduced config; ``--device cpu`` runs it all on the CPU.
Checkpoints go to a temporary directory that is removed at the end,
unless ``--ckpt-dir`` names one to keep (a later run with the same
``--ckpt-dir`` resumes from its latest checkpoint).

Run (on the card):
  PYTHONPATH=src python examples/train_bnn_lm_torch.py [--steps 300]
"""
import argparse
import contextlib
import tempfile

import torch

from repro_torch import configs
from repro_torch.configs.base import reduced
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train, train_init


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="keep checkpoints here and resume from them "
                         "(default: a temporary directory, removed)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    cfg = configs.get_config("bnn-lm-100m")
    if args.smoke:
        cfg = reduced(cfg)
    params = train_init(cfg, args.device)
    with (contextlib.nullcontext(args.ckpt_dir) if args.ckpt_dir else
          tempfile.TemporaryDirectory(prefix="bnn_lm_torch_ckpt_")) as ckpt:
        losses = train(
            "bnn-lm-100m", smoke=args.smoke, steps=args.steps,
            global_batch=args.global_batch, seq_len=args.seq_len,
            microbatches=1, lr=1e-3, ckpt_dir=ckpt, ckpt_every=100,
            device=args.device, params=params,
        )
    if losses:
        first, last = losses[:10], losses[-10:]
        print(f"\nfirst-{len(first)} mean loss: {sum(first) / len(first):.4f}")
        print(f"last-{len(last)} mean loss:  {sum(last) / len(last):.4f}")
    else:
        print(f"\nno step trained: {ckpt} already holds step {args.steps}")

    print("\nGreedy decode of the trained weights in packed-XNOR (bnn) "
          "inference mode:")
    with torch.no_grad():
        seqs = serve("bnn-lm-100m", smoke=args.smoke, batch=2, prompt_len=8,
                     gen=8, precision="bnn", device=args.device,
                     params=params)
    print(seqs)


if __name__ == "__main__":
    main()
