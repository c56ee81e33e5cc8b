#!/usr/bin/env python3
"""mixtral-8x7b and deepseek-v2-lite over four cards at their published
depths, and the probe of row-count-dependent float sums.

Run from the repository root on a machine with CUDA cards:

    python3 chip_ranks_full.py          # four cards, a card a rank (NCCL)
    python3 chip_ranks_full.py --rows   # one card: the rows probe alone

The four-card run serves each family at its published depth and width
over RANKS_FULL_DEPTH's mesh with chip_smoke's [ranks] (f) worker (the
weights drawn on the ranks a layer at a time), 8 prompts, 32 new each,
greedy and sampled, and checks that every rank's tokens are equal.  The
rows probe prints which row-wise float ops give a row other bits when
fewer rows run beside it: why ``spmd.on_rows`` pads a data rank's rows
to the batch's, and why the LM head runs one rank's GEMM on every rank.
Neither is part of ``chip_smoke.py``: the first needs four cards, the
second gates nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import chip_smoke as S
from chip_smoke import (RANKS_FAMILIES, RANKS_FAMILY_NEW, _median_counts,
                        _sum_launches, family_traffic, log,
                        ranks_family_worker)


def rows_probe(dev) -> dict[str, list[str]]:
    """Which row-wise float ops give a row other bits when fewer rows
    run with it (why ``spmd.on_rows`` pads a data rank's rows to the
    batch's): a row's mean of squares over the last dim (RMSNorm's) and
    a float32 GEMM by a d x 64 matrix (the router's), at deepseek's and
    mixtral's widths, half the rows against all of them."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out: dict[str, list[str]] = {"mean": [], "gemm": [], "head": []}
    for d in (2048, 4096):
        for many in (2, 8, 16, 128, 1024):
            few = many // 2
            x = torch.randn(many, d, generator=gen, device=dev)
            w = torch.randn(d, 64, generator=gen, device=dev)
            if not torch.equal(torch.mean(x * x, -1)[:few],
                               torch.mean(x[:few] * x[:few], -1)):
                out["mean"].append(f"d={d} {few}/{many}")
            if not torch.equal((x @ w)[:few], x[:few] @ w):
                out["gemm"].append(f"d={d} {few}/{many}")
    d, vocab = 4096, 32000
    w = torch.randn(d, vocab, generator=gen, device=dev) / d ** 0.5
    for m in (1, 8, 128):
        x = torch.randn(m, d, generator=gen, device=dev)
        if not torch.equal((x @ w)[:, :vocab // 2],
                           x @ w[:, :vocab // 2].contiguous()):
            out["head"].append(f"M={m} {vocab // 2}/{vocab}")
    return out


# the published depths over four cards, a card a rank: no
# one-rank reference fits one card (mixtral's 32 layers are 174 GiB of
# float32 weights), so the ranks' tokens are held to each other
RANKS_FULL_DEPTH = {"mixtral-8x7b": (1, 4), "deepseek-v2-lite-16b": (2, 2)}


def ranks_full_depth(dev, smi: str) -> dict[str, dict[str, int]]:
    """Each family at its published depth and width over
    RANKS_FULL_DEPTH's mesh of 4 spawned ranks (NCCL with a card a
    rank): the engine serves the family's 8 prompts, RANKS_FAMILY_NEW
    new each, greedy and sampled, the ranks' tokens compared at every
    step; printed: each rank's weight bytes (reckoned and kept), peak
    memory, tokens/s, a decode step's collectives."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import rank_weight_bytes, spawn_ranks
    t0 = time.perf_counter()
    jobs, paths = [], {}
    for arch, shape in RANKS_FULL_DEPTH.items():
        cfg = get_config(arch).replace(precision="bnn")
        S.log_weight_bytes(cfg, shape, rank_weight_bytes(cfg, shape),
                           "[ranks-full]")
        jobs.append({"ref": {"arch": arch, "cfg": cfg, "max_new":
                             RANKS_FAMILY_NEW, "traffic": family_traffic(
                                 cfg.vocab, seed=RANKS_FAMILIES[arch]["seed"])},
                     "prefill": [], "engine": shape})
    recs = spawn_ranks(ranks_family_worker, 4, jobs, device=dev.type,
                       timeout_s=3000)
    for j, job in enumerate(jobs):
        arch, shape = job["ref"]["arch"], job["engine"]
        rr = [r[j] for r in recs]
        paths[f"full_{arch.split('-')[0]}"] = {
            k.name: sum(r["launches"][k.name] for r in rr)
            for k in ops.KERNELS}
        S.log_weights_kept(arch, shape, rr, "[ranks-full]")
        log(f"[ranks-full] {arch}: peak GiB per rank "
            f"{[round(r['peak_bytes'] / 2 ** 30, 3) for r in rr]}")
        for i, tag in enumerate(("greedy", "sampled")):
            toks = [r[shape]["engine"]["runs"][i]["tokens"] for r in rr]
            if any(t != toks[0] for t in toks):
                raise AssertionError(f"[ranks-full] {arch} {tag}: the "
                                     "ranks' tokens differ")
            run0 = rr[0][shape]["engine"]["runs"][i]
            log(f"[ranks-full] {arch} {tag}: every rank's tokens equal "
                f"({len(toks[0])} requests x {RANKS_FAMILY_NEW} new); "
                f"total_tokens_per_s={run0['total_tokens_per_s']:.1f} "
                f"decode_tokens_per_s={run0['decode_tokens_per_s']:.1f} "
                f"steps={run0['steps']} wall_s={run0['wall_s']:.3f}; a "
                f"decode step (median of "
                f"{len(run0['decode_collectives'])}): "
                f"{json.dumps(_median_counts(run0['decode_collectives']))};"
                f" launches summed over ranks "
                f"{json.dumps(_sum_launches(rr, shape, i))}; backend "
                f"{rr[0]['backend']} on {sorted({r['device'] for r in rr})};"
                f" {smi}")
    log(f"[ranks-full] {json.dumps(paths)}; {time.perf_counter() - t0:.1f} s")
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", action="store_true",
                    help="only the rows probe, on one card")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ranks_full: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = S.phase_device()
    log(f"[ranks] a row's bits change with the rows beside it (half of "
        f"the rows vs all): {json.dumps(rows_probe(dev))}; {smi}")
    if a.rows:
        return 0
    if torch.cuda.device_count() < 4:
        print("chip_ranks_full: needs four cards", file=sys.stderr)
        return 1
    ranks_full_depth(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
