#!/usr/bin/env python3
"""Where the time goes when the port serves a model on one card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_profile.py [--arch ARCH] [--out DIR]

Serves the same seeded traffic as ``chip_smoke.py``'s serving phase of
``ARCH`` (default bnn-lm-100m at full width, 16 requests; mixtral-8x7b
and deepseek-v2-lite-16b at published width and 4 layers, 8 requests;
mamba2-1.3b at published width and depth, 48 layers, 16 requests;
jamba-1.5-large-398b at published width, the window of published layers
2-4, 12 requests; as the smoke's family phases), precision "bnn", three
times:
a warm-up run (kernel build, weight packing), a timed run, and a run
under ``torch.profiler``.  The timed and the profiled run start at the
engine (the seeded weights are made before; their packing at first use
is in both).  It prints, as JSON lines:

  * ``steps``   host wall time per engine step, split by kind (prefill
                step / decode step), and the engine's total and decode
                tokens/s, from the timed run;
  * ``device``  from the profiled run: the summed device time of every
                kernel, by name (top 20), the share of wall time the
                device spent in kernels (busy share; kernels run on one
                stream, so their times do not overlap) over the profiled
                run and over the timed run, and the share of kernel time
                in the port's own kernels;
  * ``fused_bnn_shapes``  from the profiled run: every fused BNN GEMM
                call by (M bucket, N, S) — its count and summed device
                time (the pack launch and the GEMM launch of each call,
                read from the host range the wrapper names while
                tracing).

The profiled run is slower than the timed one (tracing costs host
time); its shares are what to read, not its wall time.  ``--out``
writes the profiler's table there too.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import chip_smoke  # noqa: E402  (the smoke's traffic and engine settings)


def _workload(arch: str):
    """(cfg, engine config, prompts, new tokens, late requests, steps
    before they arrive, kernels of the path) as chip_smoke.py serves
    ``arch``."""
    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig
    if arch == "bnn-lm-100m":
        cfg = get_config(arch).replace(precision="bnn")
        return (cfg, EngineConfig(block_size=16, num_blocks=1025,
                                  max_batch=8, prefill_chunk=128,
                                  max_model_len=1024,
                                  **chip_smoke.NO_PREFIX),
                chip_smoke.traffic(cfg.vocab), 64, 8, 10,
                chip_smoke.SERVING_KERNELS)
    if arch == "mamba2-1.3b":
        cfg = get_config(arch).replace(precision="bnn")
        return (cfg, EngineConfig(**chip_smoke.MAMBA2_ENGINE),
                chip_smoke.family_traffic(cfg.vocab, seed=2, n=16,
                                          lens=(16, 1500)), 32, 4, 4,
                ("fused_bnn", "binarize_pack"))
    if arch == "jamba-1.5-large-398b":
        cfg = chip_smoke.jamba_window(get_config(arch).replace(
            precision="bnn"))
        return (cfg, EngineConfig(**chip_smoke.JAMBA_ENGINE),
                chip_smoke.jamba_traffic(cfg.vocab), 32, 4, 4,
                chip_smoke.SERVING_KERNELS)
    cfg = get_config(arch).replace(precision="bnn", n_layers=4)
    if arch == "mixtral-8x7b":
        return (cfg, EngineConfig(**chip_smoke.MIXTRAL_ENGINE),
                chip_smoke.family_traffic(cfg.vocab, (4400, 4700)), 32, 4, 4,
                ("fused_bnn", "paged_attention_ring", "binarize_pack"))
    return (cfg, EngineConfig(**chip_smoke.DEEPSEEK_ENGINE),
            chip_smoke.family_traffic(cfg.vocab, seed=1), 32, 4, 4,
            ("fused_bnn", "paged_attention_mla", "binarize_pack"))


def _serve(dev, work, watch=None):
    cfg, ecfg, prompts, max_new, n_late, late_after, required = work
    return chip_smoke.phase_serving(dev, cfg, ecfg, max_new=max_new,
                                    late_after=late_after, prompts=prompts,
                                    n_late=n_late, required=required,
                                    watch=watch)


def _steps(dev, work) -> dict:
    """Timed run: host wall per engine step, by what the step ran."""
    from repro_torch.models import transformer as M
    from repro_torch.serving import Engine
    cfg, ecfg, prompts, max_new, n_late, late_after, _req = work
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg,
                    device=dev)
    eng = Engine(params, cfg, ecfg, device=dev)
    times: dict[str, list[float]] = {"prefill+decode": [], "decode": [],
                                     "prefill": []}
    early = len(prompts) - n_late
    for p in prompts[:early]:
        eng.submit(p, max_new)
    late = prompts[early:]
    step = 0
    while late or not eng.scheduler.idle:
        if step == late_after:
            for p in late:
                eng.submit(p, max_new)
            late = []
        n_ev = len(eng.scheduler.trace)
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        kinds = {e["event"] for e in eng.scheduler.trace[n_ev:]}
        kind = "+".join(k for k in ("prefill", "decode") if k in kinds)
        if kind:
            times[kind].append(dt)
        step += 1
    st = eng.stats()
    out = {k: {"count": len(v), "mean_ms": 1e3 * float(np.mean(v)),
               "total_s": float(np.sum(v))}
           for k, v in times.items() if v}
    out["tokens_per_s"] = {"total": st["total_tokens_per_s"],
                           "decode": st["decode_tokens_per_s"]}
    return out


M_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def _m_bucket(m: int) -> str:
    lo = 1
    for hi in M_BUCKETS:
        if m <= hi:
            return str(hi) if lo == hi else f"{lo}-{hi}"
        lo = hi + 1
    return f">{M_BUCKETS[-1]}"


CSRC = Path(__file__).resolve().parent / "src" / "repro_torch" / "csrc"


def port_kernel_names() -> set[str]:
    """The name of every ``__global__`` function in the port's CUDA
    sources (``csrc/*.cu`` and ``*.cuh``)."""
    pat = re.compile(r"__global__\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    return {name for src in sorted(CSRC.glob("*.cu*"))
            for name in pat.findall(src.read_text())}


def is_port_kernel(name: str, names: frozenset[str]) -> bool:
    """Whether a traced kernel, by its demangled name (``void
    ns::kernel<...>(...)``), is one of the port's ``names``: an
    identifier of the name that opens a template or argument list."""
    return any(tok in names for tok in re.findall(r"(\w+)\s*[<(]", name))


def _is_kernel(ev) -> bool:
    """A traced device kernel (a named range's projection onto the
    device is none)."""
    return ev.device_type == torch.autograd.DeviceType.CUDA and \
        not getattr(ev, "is_user_annotation", False)


def _gemm_histogram(prof) -> list[dict]:
    """Every fused BNN GEMM call of the profiled run by (M bucket, N, S):
    its count and device time.  While the profiler runs, the wrapper
    names each call's host range ``fused_bnn M=.. N=.. S=..``; the
    kernel launches issued inside that range (the pack and the GEMM;
    the engine issues from one thread) share their correlation id with
    the kernels they started."""
    evs = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    calls = sorted((ev for ev in evs if ev.device_type == cpu
                    and ev.name.startswith("fused_bnn M=")),
                   key=lambda ev: ev.time_range.start)
    launches = sorted((ev for ev in evs if ev.device_type == cpu
                       and "LaunchKernel" in ev.name),
                      key=lambda ev: ev.time_range.start)
    kernel_ms = {ev.id: ev.time_range.elapsed_us() / 1e3
                 for ev in evs if _is_kernel(ev)}
    hist: dict[tuple[str, int, int], list[float]] = {}
    j = 0
    for call in calls:
        lo, hi = call.time_range.start, call.time_range.end
        while j < len(launches) and launches[j].time_range.start < lo:
            j += 1
        ms, n_kernels, k = 0.0, 0, j
        while k < len(launches) and launches[k].time_range.start <= hi:
            if launches[k].id in kernel_ms:
                ms += kernel_ms[launches[k].id]
                n_kernels += 1
            k += 1
        if not n_kernels:
            raise RuntimeError(f"{call.name}: no kernel traced in the call")
        m, n, s = (int(f.split("=")[1]) for f in call.name.split()[1:])
        key = (_m_bucket(m), n, s)
        hist.setdefault(key, [0, 0.0])
        hist[key][0] += 1
        hist[key][1] += ms
    return [{"m": k[0], "n": k[1], "s": k[2], "count": v[0], "device_ms": v[1]}
            for k, v in sorted(hist.items(), key=lambda kv: -kv[1][1])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="bnn-lm-100m",
                    choices=("bnn-lm-100m", "mixtral-8x7b",
                             "deepseek-v2-lite-16b", "mamba2-1.3b",
                             "jamba-1.5-large-398b"))
    ap.add_argument("--out", default=None, help="directory for the table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    work = _workload(args.arch)
    _serve(dev, work)                                             # warm-up
    gc.collect()
    steps = _steps(dev, work)
    gc.collect()
    timed_wall = sum(v["total_s"] for k, v in steps.items()
                     if k != "tokens_per_s")
    print(json.dumps({"arch": args.arch, "steps": steps,
                      "timed_wall_s": timed_wall}), flush=True)

    # traced from the engine's start: the weights' init (the timed run
    # leaves it out too) is not serving; their packing at first use is
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = []

    def start(_eng):
        torch.cuda.synchronize()
        prof.start()
        t0.append(time.perf_counter())
    _serve(dev, work, watch=start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0[0]
    prof.stop()
    kernels: dict[str, float] = {}
    for ev in prof.events():
        if _is_kernel(ev):
            dur = ev.time_range.elapsed_us() / 1e3
            kernels[ev.name] = kernels.get(ev.name, 0.0) + dur
    busy_ms = sum(kernels.values())
    names = frozenset(port_kernel_names())
    ours = sum(v for k, v in kernels.items() if is_port_kernel(k, names))
    # names cut to 80 characters can collide (template instantiations):
    # their times add up
    short: dict[str, float] = {}
    for k, v in kernels.items():
        short[k[:80]] = short.get(k[:80], 0.0) + v
    top = sorted(short.items(), key=lambda kv: -kv[1])[:20]
    print(json.dumps({"device": {
        "profiled_wall_s": wall, "kernel_ms": busy_ms,
        "busy_share": busy_ms / (1e3 * wall) if wall else float("nan"),
        # device time does not grow under tracing, host time does: the
        # same kernels over the untraced run's wall
        "busy_share_of_timed_run": busy_ms / (1e3 * timed_wall),
        "port_kernels_share_of_kernel_time": ours / busy_ms if busy_ms else 0.0,
        "top_kernels_ms": dict(top)}}), flush=True)
    print(json.dumps({"fused_bnn_shapes": _gemm_histogram(prof)}),
          flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "profile_table.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    if not busy_ms:
        print("chip_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
