#!/usr/bin/env python3
"""Time the kernels of two or more source trees in turns on one card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_ab.py --tree parent=DIR --tree change=. \\
        [--variant NAME=FILE:CONST=VALUE[,FILE:CONST=VALUE...]] \\
        [--turns parent,change,change,parent] [--what mla,pack,conv,ranks] \\
        [--out FILE]

Each ``--tree`` is a checkout of this repository (the parent's, unpacked
with ``git archive``, or this one).  Each ``--variant`` is a copy of
this tree's ``src/`` under ``build/ab/NAME`` with integer constants
changed: ``CONST`` is a ``constexpr int CONST = ...;`` of a ``.cu``/
``.cuh`` file or a top-level ``CONST = ...`` of a ``.py`` file, both
named relative to ``src/repro_torch`` (a sweep of a kernel's tile or
part sizes).  Every tree's kernel library is built first, all in
parallel; then each label of ``--turns`` runs in a process of its own,
in that order, importing that tree's ``repro_torch``, and prints one
JSON object of device times (ms a call, from CUDA-graph replays):

  mla    paged MLA attention at deepseek-v2-lite's widths (chip_smoke's
         shapes and seeds): C = 1 at B = 8 over a paged table and over a
         ring, C = 1 at B = 1, C = 128 causal; with each launch's time
         by kernel name (torch.profiler);
  pack   binarize_pack of a 768 x 768 weight and of ResNet18 conv1's
         patch matrix (12544 x 147), and, where the tree has it, the
         patch pack of conv1's 224 x 224 x 3 input;
  conv   bnn_conv2d at every groups == 1 layer of the four BNNs (batch
         1, chip_smoke's seeds), summed per network, beside cuDNN's bf16
         conv of the same sign tensors;
  ranks  chip_smoke's [ranks] (c): full-width bnn-lm-100m's engine over
         a (2, 2) mesh of 4 ranks sharing the card (gloo), phase 3's
         16 prompts x 64 new, greedy then sampled: each run's host wall
         s, and the host's us a launch (``host_launch_us``) after them.

The summary keeps, per label and row, the least of its turns, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, from ``iters`` calls captured in a
    CUDA graph (as chip_smoke.time_ms)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _launch_ms(fn, iters: int = 10) -> dict[str, float]:
    """Device time per call of each kernel ``fn`` launches, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^.*::|\(.*$", "", ev.name)
            out[name] = out.get(name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3 / iters
    return out


def _mla_rows(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    h, nope, dr, r, dv, bs, mb = 16, 128, 64, 512, 128, 16, 64
    rows = {}
    cases = {"C=1 B=8 paged": (1, None, None),
             "C=1 B=8 ring": (1, (100, 1023, 1500, 3000, 5, 700, 2047, 4000),
                              None),
             "C=1 B=1 paged kv_len 1024": (1, None, (1024,)),
             "C=128 B=8 paged": (128, None, None)}
    for name, (c, newest, lens) in cases.items():
        gen = torch.Generator(device=dev).manual_seed(2)
        rng = np.random.default_rng(11 + c)
        ring = newest is not None
        if ring:
            b = len(newest)
            newest = torch.tensor(newest, dtype=torch.int32, device=dev)
            kv_len = (newest + 1).to(torch.int32)
            q_off = newest
        else:
            if lens is None:
                lens = rng.integers(c, mb * bs + 1, size=8)
                lens[0], lens[-1] = mb * bs, 0
            b = len(lens)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            q_off = (kv_len - c).clamp_min(0) if c > 1 else kv_len - 1
            q_off = q_off.to(torch.int32).contiguous()
        nb = b * mb + 1
        tab = (1 + torch.randperm(b * mb, generator=gen, device=dev)).reshape(
            b, mb).to(torch.int32)
        q = torch.randn(b, c, h, nope + dr, device=dev, generator=gen)
        ckv = torch.randn(nb, bs, r, device=dev, generator=gen)
        krope = torch.randn(nb, bs, dr, device=dev, generator=gen)
        k_up = torch.randn(r, h * nope, device=dev, generator=gen) * r ** -0.5
        v_up = torch.randn(r, h * dv, device=dev, generator=gen) * r ** -0.5
        kw = dict(k_up=k_up, v_up=v_up, nope_dim=nope, kv_len=kv_len,
                  q_offset=q_off, causal=c > 1, ring=ring, newest=newest)
        run = lambda: pa.paged_attention_mla(q, ckv, krope, tab, **kw)
        rows[name] = {"ms": _time_ms(run), "launch_ms": _launch_ms(run)}
    return rows


def _pack_rows(dev) -> dict:
    import torch
    from repro_torch.kernels import binarize_pack as bp
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for m, s in ((768, 768), (12544, 147)):
        x = torch.randn(m, s, device=dev, generator=gen)
        rows[f"binarize_pack M={m} S={s}"] = _time_ms(
            lambda: bp.binarize_pack(x))
    if hasattr(bp, "pack_patches"):
        x = torch.randn(1, 224, 224, 3, device=dev, generator=gen)
        rows["pack_patches 224x224x3 k=7 stride 2"] = _time_ms(
            lambda: bp.pack_patches(x, 7, 7, 2, "SAME"))
    return rows


def _conv_rows(dev) -> dict:
    import torch
    from repro_torch.core import conv
    from repro_torch.photonic import workloads as wl
    try:                                 # where the tree keeps JAX's padding
        from repro_torch.core.patches import pad
    except ImportError:
        pad = conv._pad
    gen = torch.Generator(device=dev).manual_seed(1)
    nets: dict[str, dict[str, float]] = {}
    for net, make in wl.WORKLOADS.items():
        tot = nets.setdefault(net, {"bnn_conv2d": 0.0, "cudnn_bf16": 0.0})
        for layer in make():
            if layer.groups != 1:
                continue
            x = torch.randn(1, layer.h_in, layer.w_in, layer.c_in,
                            device=dev, generator=gen)
            w = torch.randn(layer.k, layer.k, layer.c_in, layer.c_out,
                            device=dev, generator=gen)
            args = {"stride": layer.stride,
                    "padding": "VALID" if layer.pad == 0 else "SAME"}
            tot["bnn_conv2d"] += _time_ms(
                lambda: conv.bnn_conv2d(x, w, **args))
            # cuDNN's bf16 conv of the sign tensors, padded as JAX pads
            xs = pad(torch.where(x >= 0, 1.0, -1.0), layer.k, layer.k, **args)
            xs = xs.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
            ws = torch.where(w >= 0, 1.0, -1.0).permute(3, 2, 0, 1)
            ws = ws.to(torch.bfloat16).contiguous()
            tot["cudnn_bf16"] += _time_ms(lambda: torch.nn.functional.conv2d(
                xs, ws, stride=layer.stride))
    nets["all four"] = {k: sum(v[k] for v in nets.values())
                        for k in ("bnn_conv2d", "cudnn_bf16")}
    return nets


def _ranks_rows(dev) -> dict:
    """``ranks`` (module docstring), with the tree's chip_smoke."""
    import chip_smoke as S
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serving import EngineConfig
    cfg = get_config("bnn-lm-100m").replace(precision="bnn")
    ecfg = EngineConfig(block_size=16, num_blocks=1025, max_batch=8,
                        prefill_chunk=128, max_model_len=1024,
                        **S.NO_PREFIX)
    recs = spawn_ranks(S.ranks_worker, 4, cfg, ecfg, S.traffic(cfg.vocab),
                       64, [], [], (2, 2), False, device="cuda",
                       timeout_s=900)
    runs = recs[0]["engine"]["runs"]
    return {"greedy_wall_s": runs[0]["wall_s"],
            "sampled_wall_s": runs[1]["wall_s"],
            "host_launch_us": S.host_launch_us(dev)}


def worker(src: Path, what: list[str]) -> None:
    """Time ``what`` with the ``repro_torch`` of ``src`` (and its
    chip_smoke, for ``ranks``); print JSON."""
    sys.path[:0] = [str(src / "src"), str(src)]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _lib
    assert Path(_lib.__file__).resolve().is_relative_to(src.resolve())
    dev = torch.device("cuda")
    _lib.LIBRARY.load()
    a = torch.randn(4096, 4096, device=dev)       # working clocks
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        a = torch.tanh(a @ a)
    rows = {}
    for part, fn in (("mla", _mla_rows), ("pack", _pack_rows),
                     ("conv", _conv_rows), ("ranks", _ranks_rows)):
        if part in what:
            rows[part] = fn(dev)
    print(json.dumps(rows), flush=True)


def _variant(name: str, edits: str) -> Path:
    """build/ab/NAME: a copy of this tree's src/ with the constants of
    ``edits`` changed."""
    dst = ROOT / "build" / "ab" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for edit in edits.split(","):
        fname, assign = edit.split(":")
        const, value = assign.split("=")
        path = dst / "src" / "repro_torch" / fname
        text = path.read_text()
        if path.suffix == ".py":
            pat = rf"^({const} = )\d+"
        else:
            pat = rf"(constexpr int {const} = )\d+"
        text, n = re.subn(pat, rf"\g<1>{value}", text, flags=re.M)
        if n != 1:
            raise SystemExit(f"{edit}: {n} matches in {path}")
        path.write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--turns", default=None)
    ap.add_argument("--what", default="mla,pack,conv")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    what = a.what.split(",")
    if a.worker:
        worker(Path(a.worker), what)
        return 0
    trees = {}
    for t in a.tree:
        label, path = t.split("=", 1)
        trees[label] = Path(path).resolve()
    for v in a.variant:
        label, edits = v.split("=", 1)
        trees[label] = _variant(label, edits)
    turns = a.turns.split(",") if a.turns else list(trees)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _lib; _lib.build()",
         str(trees[label] / "src")]) for label in trees]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    print(f"[ab] built {len(trees)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    results: dict[str, list[dict]] = {label: [] for label in trees}
    for label in turns:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(trees[label]), "--what", a.what],
            capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            raise SystemExit(f"{label} failed")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        results[label].append(row)
        print(f"[ab] {label} {json.dumps(row)}", flush=True)

    def least(rows):
        if isinstance(rows[0], dict):
            return {k: least([r[k] for r in rows]) for k in rows[0]}
        return min(rows)
    summary = {"card": smi, "turns": turns,
               "least": {label: least(rs) for label, rs in results.items()
                         if rs}}
    print(json.dumps(summary), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({"summary": summary,
                                           "turns": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
