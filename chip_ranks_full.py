#!/usr/bin/env python3
"""mixtral-8x7b and deepseek-v2-lite over four cards at their published
depths, and the probe of row-count-dependent float sums.

Run from the repository root on a machine with CUDA cards:

    python3 chip_ranks_full.py          # four cards, a card a rank (NCCL)
    python3 chip_ranks_full.py --rows   # one card: the rows probe alone
    python3 chip_ranks_full.py --train  # one card: the training probe

The four-card run serves each family at its published depth and width
over RANKS_FULL_DEPTH's mesh with chip_smoke's [ranks] (f) worker (the
weights drawn on the ranks a layer at a time), 8 prompts, 32 new each,
greedy and sampled, and checks that every rank's tokens are equal.  The
rows probe prints which row-wise float ops give a row other bits when
fewer rows (or vocab columns) run beside it: ATen's row mean and the
library GEMMs do, which is why the norms, the router and the LM head run
the fixed-order kernels ``row_norm`` and ``row_gemm``
(``kernels/rowwise.py``), whose lists must be empty (the probe fails
otherwise).  The first is not part of ``chip_smoke.py`` (it needs four
cards); the second holds the two kernels beside the library ops it
replaces.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

import chip_smoke as S
from chip_smoke import (RANKS_FAMILIES, RANKS_FAMILY_NEW, _median_counts,
                        _sum_launches, family_traffic, log,
                        ranks_family_worker)


def rows_probe(dev) -> dict[str, list[str]]:
    """Which row-wise float ops give a row other bits when fewer rows
    run with it: a row's mean of squares over the last dim (the library
    RMSNorm's) and a float32 GEMM by a d x 64 matrix (the router's), at
    deepseek's and mixtral's widths, half the rows against all of them,
    and the head GEMM over half the vocab against the whole; beside
    each, the fixed-order kernel that replaces it (``row_norm``, both
    kinds; ``row_gemm``), whose lists must be empty."""
    from repro_torch.kernels import rowwise as rw
    gen = torch.Generator(device=dev).manual_seed(3)
    out: dict[str, list[str]] = {"mean": [], "gemm": [], "head": [],
                                 "row_norm": [], "row_gemm": [],
                                 "row_gemm_head": []}
    for d in (2048, 4096):
        scale = torch.randn(d, generator=gen, device=dev)
        for many in (2, 8, 16, 128, 1024):
            few = many // 2
            x = torch.randn(many, d, generator=gen, device=dev)
            w = torch.randn(d, 64, generator=gen, device=dev)
            if not torch.equal(torch.mean(x * x, -1)[:few],
                               torch.mean(x[:few] * x[:few], -1)):
                out["mean"].append(f"d={d} {few}/{many}")
            if not torch.equal((x @ w)[:few], x[:few] @ w):
                out["gemm"].append(f"d={d} {few}/{many}")
            for layer in (False, True):
                if not torch.equal(
                        rw.row_norm_cuda(x, scale, scale, 1e-5, layer)[:few],
                        rw.row_norm_cuda(x[:few], scale, scale, 1e-5, layer)):
                    out["row_norm"].append(f"d={d} {few}/{many} "
                                           f"{'layer' if layer else 'rms'}")
            if not torch.equal(rw.row_gemm_cuda(x, w)[:few],
                               rw.row_gemm_cuda(x[:few], w)):
                out["row_gemm"].append(f"d={d} {few}/{many}")
    d, vocab = 4096, 32000
    w = torch.randn(d, vocab, generator=gen, device=dev) / d ** 0.5
    for m in (1, 8, 128):
        x = torch.randn(m, d, generator=gen, device=dev)
        half = w[:, vocab // 2:].contiguous()
        if not torch.equal((x @ w)[:, vocab // 2:], x @ half):
            out["head"].append(f"M={m} {vocab // 2}/{vocab}")
        if not torch.equal(rw.row_gemm_cuda(x, w)[:, vocab // 2:],
                           rw.row_gemm_cuda(x, half)):
            out["row_gemm_head"].append(f"M={m} {vocab // 2}/{vocab}")
    bad = {k: v for k, v in out.items() if k.startswith("row_") and v}
    if bad:
        raise AssertionError(f"the fixed-order kernels round a row by its "
                             f"neighbours: {json.dumps(bad)}")
    return out


# (rows, chunk positions L, heads H, head width P, state N) of the SSD
# contractions: mamba2-1.3b's prefill chunk of 512 (8 rows) and the
# engine's of 128 (1 row), the jamba window's, and decode steps (L = 1)
SSD_SHAPES = {"mamba2 L=512": (8, 512, 64, 64, 128),
              "mamba2 L=128": (8, 128, 64, 64, 128),
              "mamba2 L=128 B=1": (1, 128, 64, 64, 128),
              "mamba2 decode": (8, 1, 64, 64, 128),
              "mamba2 decode B=2": (2, 1, 64, 64, 128),
              "jamba L=128": (8, 128, 128, 128, 16),
              "jamba L=128 B=1": (1, 128, 128, 128, 16),
              "jamba decode": (8, 1, 128, 128, 16)}
SSD_SPLITS = ((1, 2), (2, 2), (1, 4))     # (data, model): rows, heads cut


def _padded(fn):
    """``fn`` run on inputs zero-padded back to one rank's rows and
    heads (the rank's at their own offsets), its rows and heads kept."""
    def run(m, xdt, c, b, h0, *, whole):
        rows, heads = whole
        r0, hh0 = rows - c.shape[0], heads - h0.shape[1]

        def pad(t, hd):
            shape = list(t.shape)
            shape[0] = rows
            if hd is not None:
                shape[hd] = heads
            z = t.new_zeros(shape)
            sl = [slice(r0, None)] + [slice(None)] * (t.ndim - 1)
            if hd is not None:
                sl[hd] = slice(hh0, None)
            z[tuple(sl)] = t
            return z
        out = fn(pad(m, 3), pad(xdt, 2), pad(c, None), pad(b, None),
                 pad(h0, 1))
        return out[r0:, :, hh0:]
    return run


def _ssd_forms():
    """Each contraction of the SSD (``layers/mamba2.py``) in the forms
    tried: ``flat``, the einsums as one rank first ran them (a head
    count inside a GEMM's N), ``per_head`` (every head a matrix of a
    batched matmul), and for the read-out of the state (``inter``; at
    decode L = 1) ``sum`` (a product summed over N) and ``padded`` (the
    per-head matmul on one rank's rows and heads, zero-padded), on
    (B, L, ...) inputs: m (B,L,L,H), xdt (B,L,H,P), c and b (B,L,N),
    h0 (B,H,N,P)."""
    flat = {
        "intra": lambda m, xdt, c, b, h0: torch.einsum(
            "blsh,bshp->blhp", m, xdt),
        "inter": lambda m, xdt, c, b, h0: torch.einsum(
            "bln,bhnp->blhp", c, h0),
        "states": lambda m, xdt, c, b, h0: torch.einsum(
            "...ln,...lhp->...hnp", b, xdt),
        "cb": lambda m, xdt, c, b, h0: torch.einsum("bln,bsn->bls", c, b)}
    per_head = {
        "intra": lambda m, xdt, c, b, h0: torch.matmul(
            m.permute(0, 3, 1, 2), xdt.transpose(1, 2)).transpose(1, 2),
        "inter": lambda m, xdt, c, b, h0: torch.matmul(
            c[:, None], h0).transpose(1, 2),
        "states": lambda m, xdt, c, b, h0: torch.matmul(
            b.transpose(1, 2)[:, None], xdt.transpose(1, 2)),
        "cb": flat["cb"]}
    return {"flat": flat, "per_head": per_head,
            "sum": {"inter": lambda m, xdt, c, b, h0: (
                c[:, :, None, :, None] * h0[:, None]).sum(3)},
            "padded": {"inter": _padded(per_head["inter"])}}


def ssd_probe(dev) -> dict[str, dict[str, list[str]]]:
    """Which SSD contraction gives a rank's rows and heads other bits
    than one rank's run of all of them (the slice of rows and heads
    the last rank of each of SSD_SPLITS holds): {form: {contraction:
    the shapes and splits where they differ}}."""
    gen = torch.Generator(device=dev).manual_seed(5)
    out: dict[str, dict[str, list[str]]] = {}
    # the head axis of each output
    head_dim = {"intra": 2, "inter": 2, "states": 1, "cb": None}
    for tag, (b, l, h, p, n) in SSD_SHAPES.items():
        def rnd(*s):
            return torch.randn(*s, generator=gen, device=dev)
        args = (rnd(b, l, l, h), rnd(b, l, h, p), rnd(b, l, n),
                rnd(b, l, n), rnd(b, h, n, p))
        for form, fns in _ssd_forms().items():
            bad = out.setdefault(form, {k: [] for k in fns})
            for name, fn in fns.items():
                kw = {"whole": (b, h)} if form == "padded" else {}
                whole = fn(*args, **kw)
                for d, m in SSD_SPLITS:
                    rb, hb = max(b // d, 1), h // m
                    r0, h0 = b - rb, h - hb
                    cut = (args[0][r0:, ..., h0:], args[1][r0:, :, h0:],
                           args[2][r0:], args[3][r0:], args[4][r0:, h0:])
                    got = fn(*cut, **kw)
                    want = whole[r0:]
                    if head_dim[name] is not None:
                        want = want.narrow(head_dim[name], h0, hb)
                    if not torch.equal(got, want):
                        diff = (got - want).abs().max().item()
                        bad[name].append(f"{tag} ({d}, {m}) {diff:.2e}")
    return out


# bnn-lm-100m's training shapes over (2, 2): the projections' (K, N)
# (q, k, v, o; gate, up; down), a microbatch of 4 rows of 256 tokens,
# 12 heads of 64
TRAIN_WEIGHTS = ((768, 768), (768, 2048), (2048, 768))
TRAIN_ATTN = dict(rows=4, tokens=256, heads=12, head_dim=64)


def train_probe(dev) -> dict[str, list[str]]:
    """Which of the STE GEMM's float ops give a rank's slice other bits
    than one rank's (``ops._tp_dense`` at "bnn_train" over (2, 2); a
    flipped sign of a projection's input then changes the step): alpha
    = mean |w| over K of a column-parallel weight's columns
    (``col_mean``) and as the sum over the ranks of K halves' sums
    (``row_sum``), each again with the sums in float64 (``*_f64``);
    the attention (``layers/attention.attention``) of a rank's rows and
    heads (``attn``) and of them zero-padded back to one rank's rows and
    heads (``attn_padded``)."""
    from repro_torch.layers import attention as A
    gen = torch.Generator(device=dev).manual_seed(7)
    out: dict[str, list[str]] = {k: [] for k in (
        "col_mean", "col_mean_f64", "row_sum", "row_sum_f64", "attn",
        "attn_padded")}
    for k, n in TRAIN_WEIGHTS:
        w = torch.randn(k, n, generator=gen, device=dev).abs() / k ** 0.5
        one = torch.mean(w, 0)
        one64 = (torch.sum(w, 0, dtype=torch.float64) / k).float()
        half = n // 2
        if not torch.equal(torch.mean(w[:, half:], 0), one[half:]):
            out["col_mean"].append(f"{k}x{n}")
        if not torch.equal((torch.sum(w[:, half:], 0, dtype=torch.float64)
                            / k).float(), one64[half:]):
            out["col_mean_f64"].append(f"{k}x{n}")
        parts = torch.sum(w[:k // 2], 0) + torch.sum(w[k // 2:], 0)
        if not torch.equal(parts / k, one):
            out["row_sum"].append(f"{k}x{n}")
        parts64 = (torch.sum(w[:k // 2], 0, dtype=torch.float64) +
                   torch.sum(w[k // 2:], 0, dtype=torch.float64))
        if not torch.equal((parts64 / k).float(), one64):
            out["row_sum_f64"].append(f"{k}x{n}")
    a = TRAIN_ATTN
    b, t, h, dh = a["rows"], a["tokens"], a["heads"], a["head_dim"]
    q, k_, v = (torch.randn(b, t, h, dh, generator=gen, device=dev)
                for _ in range(3))
    whole = A.attention(q, k_, v, causal=True)
    rb, hb = b // 2, h // 2
    got = A.attention(q[rb:, :, hb:], k_[rb:, :, hb:], v[rb:, :, hb:],
                      causal=True)
    if not torch.equal(got, whole[rb:, :, hb:]):
        out["attn"].append(f"(2, 2) {(got - whole[rb:, :, hb:]).abs().max():.2e}")

    def pad(x):
        z = torch.zeros_like(x)
        z[rb:, :, hb:] = x[rb:, :, hb:]
        return z
    got = A.attention(pad(q), pad(k_), pad(v), causal=True)[rb:, :, hb:]
    if not torch.equal(got, whole[rb:, :, hb:]):
        out["attn_padded"].append(
            f"(2, 2) {(got - whole[rb:, :, hb:]).abs().max():.2e}")
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
                    help="only the rows probe and the SSD probe, on one "
                         "card")
    ap.add_argument("--train", action="store_true",
                    help="only the training probe, on one card")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ranks_full: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if a.train:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        log(f"[ranks] the STE GEMM's float ops whose rank slice differs "
            f"from one rank's: {json.dumps(train_probe(dev))}; {smi}")
        return 0
    smi = S.phase_device()
    log(f"[ranks] a row's bits change with the rows beside it (half of "
        f"the rows vs all): {json.dumps(rows_probe(dev))}; {smi}")
    log(f"[ranks] SSD contractions whose rank slice (rows, heads) differs "
        f"from one rank's: {json.dumps(ssd_probe(dev))}; {smi}")
    if a.rows:
        return 0
    if torch.cuda.device_count() < 4:
        print("chip_ranks_full: needs four cards", file=sys.stderr)
        return 1
    ranks_full_depth(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
