#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (each check raises, and the script then exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch
              version, and the build of the kernel library from
              src/repro_torch/csrc/ (nvcc, sm_90a).
  2. kernels  each hand-written kernel against its plain PyTorch version
              on the card, at the main paths' shapes: fused BNN GEMM
              (bit-exact, four modes), weight packing (bit-exact), paged
              GQA attention (float32, MAX_ATTN_ERR); the ring variant at
              mixtral's shapes (C = 1 and a C = 128 causal chunk, rows
              below and above the ring's capacity and one under a block;
              MAX_ATTN_ERR) and the MLA variant at deepseek-v2-lite's
              (C = 1, C = 128 causal, a ring case; MAX_MLA_REL_ERR;
              untimed at C = 2, 4, 5, 17 around its decode block and
              prefill tile, with a window cutting a block, and ring
              chunks over a ring that has just wrapped).  The GQA, ring
              and MLA decode walks also at kv_len around their part
              boundaries (and 0, 1, BS - 1), over rings whose visible
              arc wraps at a part boundary, under windows that cut a
              part; each row of a C = 1 call bit-equal to the same row
              run alone (B = 1); GQA and ring timed at B = 8 and B = 1.
              Each is timed (device time, from CUDA-graph replays; and
              called from Python, eager) beside its plain version, one
              library call as a yardstick (for MLA the absorbed form in
              PyTorch calls, k_up matmul + SDPA over the latents + v_up
              matmul, with the decompressing form beside it), and its
              bound on this card; a kernel faster than its bound fails
              the run.  MLA rows add the device time of each launch by
              kernel name (torch.profiler).
  3. serving  bnn-lm-100m at full width (precision="bnn", seeded random
              weights) served by the port's Engine: 16 requests, 8 of
              them submitted after 10 steps.  The serving kernels'
              launch counts over this run must be > 0.
  4. e2e      two finished requests re-run by two routes, each once
              through the kernels and once through the plain versions,
              each attention and each FFN / MoE sublayer on the kernel
              route's input: the sign bits of every BNN projection's
              input equal (a flip is accepted only within 1e-5 x its
              row's RMS of zero, and printed), an MoE routing
              difference only at a router near-tie of the plain path
              (gap < MAX_ROUTE_GAP, printed), the outputs within
              MAX_HIDDEN_ERR elsewhere.  Route 1, a decode replay: the
              prompt in the engine's prefill chunks, then every
              generated position as a C = 1 decode step at the row,
              padded batch and table width the engine gave it; its
              kernel route's greedy tokens equal the engine's exactly.
              Route 2, teacher-forced prefill_chunk chunks of the whole
              sequence: held to the replay sublayer by sublayer (the
              first difference must be one of the accepted kinds, and
              is printed), its greedy tokens equal the engine's up to
              that point.
  5. conv     the paper's binarized-conv path (core/conv.bnn_conv2d) at
              every groups == 1 layer of VGG-small, ResNet18,
              MobileNet_V2 and ShuffleNet_V2 (photonic/workloads.py),
              batch 1, published shapes, seeded inputs and weights:
              the XNOR-popcount GEMM kernel bit-exact against its plain
              version in four modes (edge shapes around its routes and
              tiles, an ip view at an odd word offset, every route of
              its plan; then every distinct layer shape, timed in
              "dot" mode), weight/patch
              packing bit-exact at the patch shapes, the patch-packing
              kernel (patches read from the NHWC input) bit-exact
              against im2col + pack at every distinct layer input,
              timed, and at thresholds that tell its two padding rules
              apart, every layer through
              the kernels equal to its plain path and to the sign-conv
              oracle exactly (launch counts over that run must be > 0;
              device times summed per network), and a chained binary
              VGG-small stack conv2..conv6 equal on all three routes.
  6. photonic the engine's modelled OXBNN section from the serving run
              and the simulator's Fig. 7 comparison — modelled numbers
              of the photonic accelerators, not measurements.
  7. families mixtral-8x7b (GQA, sliding-window ring, MoE) and
              deepseek-v2-lite-16b (MLA latents, MoE with shared
              experts, a leading dense layer) at their published widths,
              4 layers each, seeded random weights, one after the other:
              8 requests each (mixtral: two prompts of 4400 and 4700
              tokens, longer than its ring, the rest 64-512 tokens), 32
              new tokens, 4 submitted after 4 steps; the ring must wrap
              (ring_reuses > 0), each path's kernels must launch, and
              finished requests go through the phase-4 check (mixtral:
              the first, whose ring wrapped, and the shortest;
              deepseek: all eight).  Prints tokens/s, ring reuses and
              peak memory.  Then mamba2-1.3b (the Mamba-2 SSD mixer
              over recurrent slots, no FFN) at its published widths
              and depth, 48 layers: 16 requests of 16-1500 tokens, 32
              new tokens, 4 submitted after 4 steps, 5 slots under a
              batch of 8, so admissions wait for a slot and released
              slots are handed out again (zeroed); the longest request
              and the first on a reused slot are re-checked (the
              replay in the engine's slot; the chunked re-check runs
              the SSD dual form where the engine ran the recurrence,
              and prints how far apart they are).  Phase 2 checks and
              times the
              fused BNN GEMM at mamba2's in_proj (N = 8512, K = 2048)
              and out_proj (N = 2048, K = 4096) at M = 1, 8, 128, and
              each weight's pack.  Last, with everything before it
              freed, the jamba hybrid (jamba-1.5-large-398b) at
              published width, the window of published layers 2-4
              ((ssm, dense), (gqa, moe), (ssm, dense); ≈ 52 GB of
              float32 weights): 12 requests of 16-1500 tokens, 32 new
              tokens, 4 submitted after 4 steps, 5 recurrent slots and
              256 blocks under a batch of 8.  All 5 slots must be in
              use at once; from the cache's recorded admissions and the
              trace's no_blocks defers, one admission must wait for a
              slot while the blocks were free, and one must find a
              slot but too few blocks and give the slot back.  The
              longest request and the first that gave a slot back are
              re-checked, the replay in the engine's own slot and
              block table.  Phase 2 checks and times the three kernels
              of its path at its shapes: the fused BNN GEMM at every
              projection (in_proj N = 32928, out_proj, q/o, k/v, the
              FFN's and each expert's w1/w3 and w2) at M = 1, 8, 128
              and an expert's routed rows at prefill (M = 16), the pack
              of in_proj's weight and of an expert matrix, and paged
              GQA at H = 64, Hkv = 8, Dh = 128 (B = 8 and 1, C = 1 and
              128; kv_len around the decode walk's parts, C around its
              tile).

The line before the last is a JSON object with every kernel's launches
on its paths (serving, conv, mixtral, deepseek, mamba2, jamba), error,
times and bound; the last line is the run's verdict with the device.
Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import functools
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50 * 2 ** 20          # H100 L2 cache (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12         # densest documented integer rate: int8
                                 # tensor cores (the binary mma's is
                                 # measured: b1_ops_per_s)
FP32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
TF32X3_FLOPS_PER_S = 495e12 / 3  # float32 work as 3xTF32 tensor-core
                                 # products: the TF32 data-sheet rate / 3
MAX_ATTN_ERR = 1e-4              # |kernel - plain| for attention outputs
MAX_MLA_REL_ERR = 1e-4           # MLA: |kernel - plain| <= this x
                                 # max(1, max|plain|); the kernel's absorbed
                                 # order sums the R = 512 latent terms
                                 # differently
MAX_ROUTE_GAP = 1e-6             # an MoE routing difference is rounding only
                                 # where the plain path's k-th and (k+1)-th
                                 # router probabilities are closer than this
MAX_HIDDEN_ERR = 1e-4            # |kernels - plain| per layer hidden state
FLIP_RMS_FRACTION = 1e-5         # a sign flip closer to 0 than this x RMS
                                 # is rounding, not a fault
MODES = ("bitcount", "dot", "dot_scaled", "binary_act")   # BNN GEMM epilogues


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call: ``iters`` calls captured in a CUDA
    graph, replayed between two CUDA events.  A replay issues the
    kernels with no per-call host work, so this is the device's time
    (host launch cost is what ``eager_ms`` adds)."""
    fn()                                    # build, allocate, warm up
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


def eager_ms(fn, iters: int = 20) -> float:
    """Mean time of one call issued from Python, back to back: the host's
    launch cost where it exceeds the device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(fn, iters: int = 10) -> dict[str, float]:
    """Device time per call of each kernel ``fn`` launches, by kernel
    name, from a ``torch.profiler`` trace of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            out[ev.name] = out.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3 / iters
    if not out:
        raise AssertionError("the profiler traced no kernel on the card")
    return out


def cold_inputs(x: torch.Tensor):
    """A callable that returns ``x`` or one of its copies in turn: where
    ``x`` is over an eighth of the L2 cache, enough copies that the
    replays of ``time_ms`` read it from device memory, as a first use
    does, not from L2."""
    n = x.numel() * x.element_size()
    copies = [x]
    if n > L2_BYTES // 8:
        copies += [x.clone() for _ in range(-(-2 * L2_BYTES // n))]
    it = itertools.cycle(copies)
    return lambda: next(it)


def check_bound(row: dict, what: str) -> None:
    """A kernel faster than its bound means a wrong bound: refuse it."""
    if not row["bound_ms"] <= row["ms"]:
        raise AssertionError(f"{what} {row['shape']}: {row['ms']:.5g} ms "
                             f"beats its bound {row['bound_ms']:.5g} ms")


def warm_clocks(dev, seconds: float = 1.0):
    """Keep the card busy for a moment so that timings start at its
    working clocks, not its idle ones."""
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = torch.tanh(a @ a)
    torch.cuda.synchronize()


@functools.lru_cache(maxsize=None)
def b1_ops_per_s(dev) -> float:
    """The binary tensor-core product's rate on this card, measured once:
    a tight loop of independent mma.m16n8k256.b1 (AND + popcount) in 4
    blocks of 8 warps per SM (csrc/fused_bnn.cu ``fb_b1_mma_rate``),
    2 x 16 x 8 x 256 operations an mma, as int8's 2 M N K."""
    from repro_torch.kernels import _lib
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    iters, reps = 4096, 5
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    probe = lambda: _lib.launch("fb_b1_mma_rate", out.device, _lib.ptr(out),
                                blocks, iters)
    probe()                                      # build, warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        probe()
    end.record()
    torch.cuda.synchronize()
    n_ops = reps * blocks * 8 * iters * 8 * 2 * 16 * 8 * 256
    return n_ops / (start.elapsed_time(end) / 1e3)


def xnor_gemm_ops_per_s(dev) -> float:
    """The rate of an XNOR-popcount GEMM's bound: the faster of the int8
    data-sheet rate and the binary mma's measured one."""
    return max(INT8_OPS_PER_S, b1_ops_per_s(dev))


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 1


def phase_device() -> str:
    from repro_torch.kernels import _lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    _lib.LIBRARY.load()
    log(f"[device] kernel library {_lib.LIBRARY.path.name} built in "
        f"{_lib.LIBRARY.build_s:.1f} s")
    dev = torch.device("cuda")
    warm_clocks(dev)
    log(f"[device] binary mma.m16n8k256 rate {b1_ops_per_s(dev) / 1e12:.1f} "
        f"TOP/s measured (int8 data sheet {INT8_OPS_PER_S / 1e12:.0f}); "
        f"XNOR GEMM bounds use {xnor_gemm_ops_per_s(dev) / 1e12:.1f}")
    return smi


# --------------------------------------------------------------- phase 2
#
# Each check builds the main path's inputs, holds the kernel against its
# plain version, and returns a row for the kernel table.


def check_fused_bnn(dev, m: int, n: int, s: int, gen: torch.Generator,
                    timed: bool) -> dict:
    """The kernel bit-exact against the plain version in all four modes;
    timed in "dot_scaled"."""
    from repro_torch.kernels import binarize_pack as bp, fused_bnn as fb
    x = torch.randn(m, s, device=dev, generator=gen)
    w = torch.randn(s, n, device=dev, generator=gen)
    wp = bp.binarize_pack_torch(w.t().contiguous())
    alpha = torch.rand(n, device=dev, generator=gen) + 0.5
    for mode in MODES:
        got = fb.fused_bnn_matmul(x, wp, s, mode=mode, alpha=alpha)
        want = fb.fused_bnn_matmul_torch(x, wp, s, mode=mode, alpha=alpha)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = (got.float() != want.float()).sum().item()
            raise AssertionError(f"fused_bnn M={m} N={n} S={s} {mode}: {bad} "
                                 "elements differ from the plain version")
    row = {"shape": f"M={m} N={n} S={s}", "max_abs_err": 0.0}
    if timed:
        kw = -(-s // 32)
        n_bytes = m * s * 4 + n * kw * 4 + n * 4 + m * n * 4
        row["bound_ms"], row["bound_by"] = bound_ms(
            n_bytes, 2 * m * n * s, xnor_gemm_ops_per_s(dev))
        run = lambda: fb.fused_bnn_matmul(x, wp, s, mode="dot_scaled",
                                          alpha=alpha)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(lambda: fb.fused_bnn_matmul_torch(
            x, wp, s, mode="dot_scaled", alpha=alpha), iters=3)
        xs = torch.where(x >= 0, 1.0, -1.0).to(torch.bfloat16)
        ws = torch.where(w >= 0, 1.0, -1.0).to(torch.bfloat16)
        row["library_ms"] = time_ms(lambda: torch.matmul(xs, ws))
        row["beats_library"] = row["ms"] < row["library_ms"]
        check_bound(row, "fused_bnn")
    return row


def check_binarize_pack(dev, m: int, s: int, gen: torch.Generator,
                        timed: bool) -> dict:
    from repro_torch.kernels import binarize_pack as bp
    x = torch.randn(m, s, device=dev, generator=gen)
    got = bp.binarize_pack(x)
    want = bp.binarize_pack_torch(x)
    if not torch.equal(got, want):
        raise AssertionError(f"binarize_pack {m}x{s}: "
                             f"{(got != want).sum().item()} words differ")
    row = {"shape": f"M={m} S={s}", "max_abs_err": 0.0}
    if timed:
        kw = -(-s // 32)
        row["bound_ms"], row["bound_by"] = bound_ms(m * s * 4 + m * kw * 4,
                                                    m * s, INT8_OPS_PER_S)
        xs = cold_inputs(x)
        row["ms"] = time_ms(lambda: bp.binarize_pack(xs()))
        row["eager_ms"] = eager_ms(lambda: bp.binarize_pack(xs()))
        row["plain_ms"] = time_ms(lambda: bp.binarize_pack_torch(x), iters=5)
        row["library_ms"] = None
        check_bound(row, "binarize_pack")
    return row


def check_pack_patches(dev, x: torch.Tensor, k: int, stride: int,
                       padding: str, timed: bool,
                       threshold: float = 0.0) -> dict:
    """The patch-packing kernel bit-exact against its plain version (the
    patch matrix written out, then packed) on the NHWC input ``x`` of a
    k x k conv; timed against its byte bound: the input read once, the
    words written once."""
    from repro_torch.kernels import binarize_pack as bp
    args = (x, k, k, stride, padding)
    got = bp.pack_patches(*args, threshold=threshold)
    want = bp.pack_patches_torch(*args, threshold=threshold)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"pack_patches {tuple(x.shape)} k={k} "
                             f"stride={stride} {padding} thr={threshold}: "
                             f"words differ from the plain version")
    row = {"shape": f"x={tuple(x.shape)} k={k} stride={stride} {padding}",
           "M": got.shape[0], "S": k * k * x.shape[-1], "max_abs_err": 0.0}
    if timed:
        n_bytes = x.numel() * 4 + got.numel() * 4
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, got.numel() * 32,
                                                    INT8_OPS_PER_S)
        run = lambda: bp.pack_patches(*args)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(lambda: bp.pack_patches_torch(*args),
                                  iters=5)
        row["library_ms"] = None
        check_bound(row, "pack_patches")
    return row


def _check_rows_alone(got: torch.Tensor, alone, what: str) -> None:
    """The batch-invariance gate: row i of a batched call ``got`` equals,
    bit for bit, ``alone(i)``, the same row run as a batch of one."""
    for i in range(got.shape[0]):
        if not torch.equal(alone(i), got[i:i + 1]):
            raise AssertionError(f"{what}: row {i} differs from the same "
                                 "row run alone (B = 1)")


def check_paged_attention(dev, b: int, c: int, h: int, hkv: int, dh: int,
                          bs: int, max_len: int, gen: torch.Generator,
                          timed: bool, window: int | None = None,
                          lens=None) -> dict:
    """Ragged kv_len up to ``max_len`` over shuffled physical blocks (the
    first row at it; with B > 1 the last row has kv_len 0: fully
    masked), or the given ``lens``.  C > 1 runs causal, with each row's
    queries ending at its last key (a prefill chunk).  At C = 1 each row
    of the batch must equal, bit for bit, the same row run alone."""
    from repro_torch.kernels import paged_attention as pa
    mb = -(-max_len // bs)
    rng = np.random.default_rng(7)
    if lens is None:
        lens = rng.integers(c, max_len + 1, size=b)
        lens[0] = max_len
        if b > 1:
            lens[-1] = 0
    lens = np.asarray(lens)
    b = len(lens)
    nb = b * mb + 1
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q_off = (kv_len - c).clamp_min(0) if c > 1 else kv_len - 1
    q_off = q_off.to(torch.int32).contiguous()
    tab = torch.tensor(table, device=dev)
    q = torch.randn(b, c, h, dh, device=dev, generator=gen)
    kp = torch.randn(nb, bs, hkv, dh, device=dev, generator=gen)
    vp = torch.randn(nb, bs, hkv, dh, device=dev, generator=gen)
    causal = c > 1
    kw = dict(kv_len=kv_len, q_offset=q_off, causal=causal, window=window)
    got = pa.paged_attention(q, kp, vp, tab, **kw)
    want = pa.paged_attention_torch(q, kp, vp, tab, **kw)
    err = (got - want).abs().max().item()
    if not err <= MAX_ATTN_ERR:
        raise AssertionError(f"paged_attention B={b} C={c}: max abs err "
                             f"{err:.3g} > {MAX_ATTN_ERR}")
    for i in np.flatnonzero(lens == 0):
        if got[i].abs().max().item() != 0.0:
            raise AssertionError("paged_attention: fully-masked row is not "
                                 "zero")
    if c == 1:
        _check_rows_alone(
            got, lambda i: pa.paged_attention(
                q[i:i + 1], kp, vp, tab[i:i + 1], kv_len=kv_len[i:i + 1],
                q_offset=q_off[i:i + 1], causal=causal, window=window),
            f"paged_attention B={b} C=1")
    row = {"shape": f"B={b} C={c} H={h} Hkv={hkv} Dh={dh} BS={bs} "
                    f"kv_len<={max_len}", "max_abs_err": err}
    if timed:
        # what this run's data needs: each row's visible keys once
        qpos = q_off.long()[:, None] + torch.arange(c, device=dev)
        vis = torch.minimum(qpos + 1, kv_len.long()[:, None]) if causal \
            else kv_len.long()[:, None].expand(b, c)
        vis = vis.clamp_min(0)
        n_keys = int(kv_len.clamp_min(0).sum())
        n_bytes = (2 * n_keys * hkv * dh + 2 * q.numel()) * 4 + tab.numel() * 4
        n_ops = 4 * int(vis.sum()) * h * dh
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops,
                                                    FP32_FLOPS_PER_S)
        run = lambda: pa.paged_attention(q, kp, vp, tab, **kw)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(
            lambda: pa.paged_attention_torch(q, kp, vp, tab, **kw), iters=5)
        # yardstick: SDPA over the already-gathered K/V (heads repeated
        # for GQA) with a bool mask
        keys = kp[tab.long()].reshape(b, mb * bs, hkv, dh)
        vals = vp[tab.long()].reshape(b, mb * bs, hkv, dh)
        keys = keys.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        vals = vals.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        kpos = torch.arange(mb * bs, device=dev)
        mask = kpos[None, None] < kv_len.long()[:, None, None]
        if causal:
            mask = mask & (qpos[:, :, None] >= kpos)
        mask = mask[:, None].expand(b, h, c, mb * bs)
        qt = q.transpose(1, 2)
        fsdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: fsdpa(qt, keys, vals,
                                                  attn_mask=mask))
        row["beats_library"] = row["ms"] < row["library_ms"]
        check_bound(row, "paged_attention")
    return row


# (M, N, S) of the families' BNN GEMMs, timed in phase 2; an expert's
# M is the rows routed to it, spread over 1-128 at prefill and 1-2 at
# decode (chip_profile.py's fused_bnn_shapes)
FAMILY_GEMMS = (
    (128, 4096, 4096), (128, 1024, 4096),     # mixtral q/o, k/v
    (128, 14336, 4096), (32, 14336, 4096),    # an expert's w1/w3: prefill
    (32, 4096, 14336),                        # ... w2: prefill
    (1, 14336, 4096), (2, 4096, 14336),       # w1/w3, w2: decode
    (12, 1408, 2048), (1, 2048, 1408),        # deepseek expert w1, w2
)


# mamba2-1.3b's BNN weights (K, N): in_proj (2 d_inner + 2 state + heads
# = 8512 outputs) and out_proj; and the reduced config's (d_model 64)
MAMBA2_WEIGHTS = {"in_proj": (2048, 8512), "out_proj": (4096, 2048)}
MAMBA2_REDUCED_WEIGHTS = ((64, 304), (128, 64))


# jamba-1.5-large's BNN weights (K, N) in the served window (layers 2-4):
# SSD in_proj (2 d_inner + 2 state + heads = 32928 outputs, a tail at
# every N tile) and out_proj, attention q/o and k/v, the dense FFN's and
# each expert's w1/w3 and w2
JAMBA_WEIGHTS = {"in_proj": (8192, 32928), "out_proj": (16384, 8192),
                 "q/o": (8192, 8192), "k/v": (8192, 1024),
                 "w1/w3": (8192, 24576), "w2": (24576, 8192)}
# an expert's routed rows in a 128-token prefill chunk (top-2 of 16: 16
# on average); at decode (8 rows: 1) they are the M = 1 rows above
JAMBA_EXPERT_PREFILL_M = 16


def phase_kernels(dev, cfg) -> dict[str, list[dict]]:
    warm_clocks(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.head_dim
    rows: dict[str, list[dict]] = {"fused_bnn": [], "binarize_pack": [],
                                   "paged_attention": []}
    for m in (1, 8, 128):
        for n, s in ((hd, d), (f, d), (d, f), (d, 100)):
            rows["fused_bnn"].append(check_fused_bnn(dev, m, n, s, gen, True))
    weights = {"q": (d, hd), "k": (d, cfg.n_kv_heads * cfg.head_dim),
               "v": (d, cfg.n_kv_heads * cfg.head_dim), "o": (hd, d),
               "gate": (d, f), "up": (d, f), "down": (f, d)}
    for name, (k_in, n_out) in weights.items():
        # a weight (K, N) packs as its transpose (N, K)
        rows["binarize_pack"].append(
            {"weight": name, **check_binarize_pack(dev, n_out, k_in, gen, True)})
    for c in (1, 128):
        rows["paged_attention"].append(check_paged_attention(
            dev, 8, c, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16, 1024,
            gen, True))
    # the engine's smallest decode bucket: one row over the whole table
    rows["paged_attention"].append(check_paged_attention(
        dev, 1, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16, 1024, gen,
        True))
    # the served families' widths (section "families"): mixtral's
    # attention projections at a prefill chunk, its experts' w1/w3 and w2
    # at the rows an expert gets in a prefill step and at decode, and a
    # deepseek-v2-lite expert's
    for m, n, s in FAMILY_GEMMS:
        rows["fused_bnn"].append(check_fused_bnn(dev, m, n, s, gen, True))
    # mamba2-1.3b's in_proj (N = 8512, not a multiple of any N tile) and
    # out_proj at a decode row, a full decode bucket and a prefill chunk,
    # and each weight's pack; the reduced config's untimed
    for name, (k_in, n_out) in MAMBA2_WEIGHTS.items():
        for m in (1, 8, 128):
            rows["fused_bnn"].append({"weight": f"mamba2 {name}",
                                      **check_fused_bnn(dev, m, n_out, k_in,
                                                        gen, True)})
        rows["binarize_pack"].append(
            {"weight": f"mamba2 {name}",
             **check_binarize_pack(dev, n_out, k_in, gen, True)})
    for k_in, n_out in MAMBA2_REDUCED_WEIGHTS:
        for m in (1, 8, 128):
            check_fused_bnn(dev, m, n_out, k_in, gen, False)
    # edges, untimed and bit-exact: row counts around both paths' tiles,
    # N not a multiple of any tile, S around word and tile boundaries
    for m in (1, 2, 3, 17, 33, 127, 129, 257):
        for s in (100, 4095, 4097, 14336):
            check_fused_bnn(dev, m, 77, s, gen, False)
    check_paged_attention(dev, 3, 4, 12, 4, 64, 16, 100, gen, False)
    # the decode walk's parts: kv_len one short of, at and one past a part
    # boundary (k * DECODE_PART_KEYS), 0, 1 and BS - 1; at bnn-lm-100m's
    # heads and at G = 4, Dh = 128, with and without a window that cuts
    # a part
    from repro_torch.kernels.paged_attention import DECODE_PART_KEYS as kp
    edges = (kp - 1, kp, kp + 1, 3 * kp - 1, 3 * kp, 3 * kp + 1, 0, 1, 15)
    for h, hkv, dh, window in ((12, 12, 64, None), (16, 4, 128, None),
                               (16, 4, 128, 300)):
        check_paged_attention(dev, 0, 1, h, hkv, dh, 16, 1024, gen, False,
                              window=window, lens=edges)
    check_paged_attention(dev, 3, 4, 4, 2, 16, 4, 40, gen, False, window=5)
    # attention around the decode tile (R = C * G = 16) and the prefill
    # tile (64 rows): G = 4 at C = 4, 5, 17, 128, Dh = 128 and 64, with a
    # window that cuts a block and a key tile mid-way
    for c in (4, 5, 17, 128):
        for dh, window in ((128, None), (128, 100), (64, 37)):
            check_paged_attention(dev, 3, c, 16, 4, dh, 16, 700, gen, False,
                                  window=window)
    check_paged_attention(dev, 3, 17, 12, 12, 64, 16, 300, gen, False)
    # a head width the tiled path is not built for: R = 68 query rows
    # take the decode walk, 16 rows a block
    for window in (None, 37):
        check_paged_attention(dev, 3, 17, 16, 4, 32, 16, 300, gen, False,
                              window=window)
    for name, rs in rows.items():
        for r in rs:
            log(f"[kernels] {name} {json.dumps(r)}")
    return rows


def phase_jamba_kernels(dev, rows: dict[str, list[dict]]) -> None:
    """The three kernels of the jamba window's path at its shapes, each
    against its plain version, timed; rows appended to ``rows``: the
    fused BNN GEMM at every projection (M = 1, 8, 128) and an expert's
    routed rows at prefill, the pack of in_proj's weight and of one
    expert matrix, and paged GQA (ring off) at H = 64, Hkv = 8 (group
    8), Dh = 128 over a 2048-token table, B = 8 and 1, C = 1 and 128;
    untimed, kv_len around the decode walk's parts and C around its
    16-row tile (C * G = 16, 24, 136)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    new = {k: [] for k in ("fused_bnn", "binarize_pack", "paged_attention")}
    for name, (k_in, n_out) in JAMBA_WEIGHTS.items():
        ms = (1, 8, 128) + ((JAMBA_EXPERT_PREFILL_M,) if name in
                            ("w1/w3", "w2") else ())
        for m in ms:
            new["fused_bnn"].append({"weight": f"jamba {name}",
                                     **check_fused_bnn(dev, m, n_out, k_in,
                                                       gen, True)})
    for name in ("in_proj", "w1/w3"):
        k_in, n_out = JAMBA_WEIGHTS[name]
        new["binarize_pack"].append(
            {"weight": f"jamba {name}",
             **check_binarize_pack(dev, n_out, k_in, gen, True)})
    for b, c in ((8, 1), (1, 1), (8, 128), (1, 128)):
        new["paged_attention"].append(
            {"model": "jamba", **check_paged_attention(
                dev, b, c, 64, 8, 128, 16, 2048, gen, True)})
    from repro_torch.kernels.paged_attention import DECODE_PART_KEYS as kp
    check_paged_attention(dev, 0, 1, 64, 8, 128, 16, 2048, gen, False,
                          lens=(kp - 1, kp, kp + 1, 4 * kp - 1, 4 * kp,
                                4 * kp + 1, 7 * kp + 1, 2047, 2048, 0, 1,
                                15))
    for c in (2, 3, 17):
        check_paged_attention(dev, 3, c, 64, 8, 128, 16, 700, gen, False)
    for name, rs in new.items():
        for r in rs:
            log(f"[kernels] {name} {json.dumps(r)}")
        rows[name] += rs


def _ragged_rows(b, c, max_len, rng, dev):
    """kv_len up to ``max_len`` (the first row at it, the last 0: fully
    masked) and the q_offset of a decode (c = 1) or a prefill chunk."""
    lens = rng.integers(c, max_len + 1, size=b)
    lens[0], lens[-1] = max_len, 0
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q_off = (kv_len - c).clamp_min(0) if c > 1 else kv_len - 1
    return kv_len, q_off.to(torch.int32).contiguous()


def _visible(kpos, kv_len, q_off, c, causal, window):
    """(B, C, S) bool: the keys each chunk query sees (the masks of the
    kernels' plain versions)."""
    qpos = q_off.long()[:, None] + torch.arange(c, device=kpos.device)
    m = ((kpos >= 0) & (kpos < kv_len.long()[:, None]))[:, None, :]
    m = m.expand(kpos.shape[0], c, kpos.shape[1])
    if causal:
        m = m & (qpos[:, :, None] >= kpos[:, None, :])
    if window:
        m = m & (qpos[:, :, None] - kpos[:, None, :] < window)
    return m


RING_NEWEST = (100, 2000, 4223, 4300, 6000, 8191, 5, 3000)


def check_ring_attention(dev, c: int, gen: torch.Generator,
                         timed: bool, newest=RING_NEWEST,
                         window: int = 4096) -> dict:
    """mixtral's ring at its published shapes: B=8, H=32, Hkv=8, Dh=128,
    BS=16, MB=264 (4224 slots), window 4096.  ``newest`` covers rows
    below the capacity (slots never written), above it (wrapped) and a
    kv_len below one block.  C > 1 is a causal prefill chunk ending at
    ``newest``."""
    from repro_torch.kernels import paged_attention as pa
    b, h, hkv, dh, bs, mb = len(newest), 32, 8, 128, 16, 264
    newest = torch.tensor(newest, dtype=torch.int32, device=dev)
    kv_len = (newest + 1).to(torch.int32)
    q_off = newest if c == 1 else (kv_len - c).clamp_min(0).to(torch.int32)
    causal = c > 1
    nb = b * mb + 1
    tab = (1 + torch.randperm(b * mb, generator=gen, device=dev)).reshape(
        b, mb).to(torch.int32)
    q = torch.randn(b, c, h, dh, device=dev, generator=gen)
    kp = torch.randn(nb, bs, hkv, dh, device=dev, generator=gen)
    vp = torch.randn(nb, bs, hkv, dh, device=dev, generator=gen)
    kw = dict(kv_len=kv_len, q_offset=q_off, causal=causal, window=window,
              ring=True, newest=newest)
    got = pa.paged_attention(q, kp, vp, tab, **kw)
    want = pa.paged_attention_torch(q, kp, vp, tab, **kw)
    err = (got - want).abs().max().item()
    if not err <= MAX_ATTN_ERR:
        raise AssertionError(f"paged_attention ring C={c} window={window} "
                             f"newest={newest.tolist()}: max abs err "
                             f"{err:.3g} > {MAX_ATTN_ERR}")
    kpos = pa.ring_key_positions(newest, mb, bs)
    vis = _visible(kpos, kv_len, q_off, c, causal, window)
    blind = ~vis.any(dim=-1)                    # (B, C): rows that see no key
    if blind.any() and got[blind].abs().max().item() != 0.0:
        raise AssertionError(f"paged_attention ring C={c}: a fully-masked "
                             "row is not zero")
    if c == 1:
        _check_rows_alone(
            got, lambda i: pa.paged_attention(
                q[i:i + 1], kp, vp, tab[i:i + 1], kv_len=kv_len[i:i + 1],
                q_offset=q_off[i:i + 1], causal=causal, window=window,
                ring=True, newest=newest[i:i + 1]),
            f"paged_attention ring B={b} C=1")
    row = {"shape": f"B={b} C={c} H={h} Hkv={hkv} Dh={dh} BS={bs} MB={mb} "
                    f"window={window} newest={newest.tolist()}",
           "max_abs_err": err}
    if timed:
        # what this run's data needs: each row's visible keys once
        n_keys = int(vis.any(dim=1).sum())
        n_bytes = (2 * n_keys * hkv * dh + 2 * q.numel()) * 4 + \
            tab.numel() * 4
        n_ops = 4 * int(vis.sum()) * h * dh
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops,
                                                    FP32_FLOPS_PER_S)
        run = lambda: pa.paged_attention(q, kp, vp, tab, **kw)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(
            lambda: pa.paged_attention_torch(q, kp, vp, tab, **kw), iters=3)
        # yardstick: SDPA over the gathered K/V (heads repeated for GQA)
        # with the ring's mask
        keys = kp[tab.long()].reshape(b, mb * bs, hkv, dh)
        vals = vp[tab.long()].reshape(b, mb * bs, hkv, dh)
        keys = keys.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        vals = vals.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        mask = vis[:, None].expand(b, h, c, mb * bs)
        qt = q.transpose(1, 2)
        fsdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: fsdpa(qt, keys, vals,
                                                  attn_mask=mask))
        row["beats_library"] = row["ms"] < row["library_ms"]
        check_bound(row, "paged_attention")
    return row


MLA_RING_NEWEST = (100, 1023, 1500, 3000, 5, 700, 2047, 4000)


def check_mla_attention(dev, c: int, gen: torch.Generator, timed: bool,
                        ring: bool = False, newest=MLA_RING_NEWEST,
                        window: int | None = None, lens=None) -> dict:
    """deepseek-v2-lite's latent attention at its published shapes: B=8,
    H=16, nope 128, rope 64, R=512, Dv=128, BS=16, MB=64 (kv_len up to
    1024, the last row fully masked, or the given ``lens``); ``ring``
    reads the same table as a ring (``newest`` below and above its 1024
    slots; B = len(newest)).  C > 1 is a causal chunk ending at each
    row's last key.  At C = 1 each row of the batch must equal, bit for
    bit, the same row run alone."""
    from repro_torch.kernels import paged_attention as pa
    b, h, nope, dr, r, dv, bs, mb = 8, 16, 128, 64, 512, 128, 16, 64
    rng = np.random.default_rng(11 + c)
    if ring:
        b = len(newest)
        newest = torch.tensor(newest, dtype=torch.int32, device=dev)
        kv_len = (newest + 1).to(torch.int32)
        q_off = newest if c == 1 else \
            (kv_len - c).clamp_min(0).to(torch.int32)
    elif lens is not None:
        newest = None
        b = len(lens)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        q_off = (kv_len - c).clamp_min(0) if c > 1 else kv_len - 1
        q_off = q_off.to(torch.int32).contiguous()
    else:
        newest = None
        kv_len, q_off = _ragged_rows(b, c, mb * bs, rng, dev)
    causal = c > 1
    nb = b * mb + 1
    tab = (1 + torch.randperm(b * mb, generator=gen, device=dev)).reshape(
        b, mb).to(torch.int32)
    q = torch.randn(b, c, h, nope + dr, device=dev, generator=gen)
    ckv = torch.randn(nb, bs, r, device=dev, generator=gen)
    krope = torch.randn(nb, bs, dr, device=dev, generator=gen)
    k_up = torch.randn(r, h * nope, device=dev, generator=gen) * r ** -0.5
    v_up = torch.randn(r, h * dv, device=dev, generator=gen) * r ** -0.5
    kw = dict(k_up=k_up, v_up=v_up, nope_dim=nope, kv_len=kv_len,
              q_offset=q_off, causal=causal, window=window, ring=ring,
              newest=newest)
    got = pa.paged_attention_mla(q, ckv, krope, tab, **kw)
    want = pa.paged_attention_mla_torch(q, ckv, krope, tab, **kw)
    err = (got - want).abs().max().item()
    limit = MAX_MLA_REL_ERR * max(1.0, want.abs().max().item())
    if not err <= limit:
        raise AssertionError(f"paged_attention_mla C={c} ring={ring} "
                             f"window={window}: max abs err {err:.3g} > "
                             f"{limit:.3g}")
    kpos = (pa.ring_key_positions(newest, mb, bs) if ring else
            torch.arange(mb * bs, device=dev)[None].expand(b, mb * bs))
    vis = _visible(kpos, kv_len, q_off, c, causal, window)
    blind = ~vis.any(dim=-1)                    # (B, C): rows that see no key
    if blind.any() and got[blind].abs().max().item() != 0.0:
        raise AssertionError(f"paged_attention_mla C={c} ring={ring}: a "
                             "fully-masked row is not zero")
    if c == 1:
        _check_rows_alone(
            got, lambda i: pa.paged_attention_mla(
                q[i:i + 1], ckv, krope, tab[i:i + 1], **{
                    **kw, "kv_len": kv_len[i:i + 1],
                    "q_offset": q_off[i:i + 1],
                    "newest": None if newest is None else newest[i:i + 1]}),
            f"paged_attention_mla B={b} C=1 ring={ring} window={window}")
    tiled = pa.mla_tiled(c, h, r, dr)
    row = {"shape": f"B={b} C={c} H={h} nope={nope} rope={dr} R={r} Dv={dv} "
                    f"BS={bs} MB={mb} ring={ring} window={window}",
           "max_abs_err": err, "limit": limit,
           "path": "tiled" if tiled else "decode"}
    if timed:
        n_keys = int(vis.any(dim=1).sum())
        rows = b * c * h
        n_bytes = n_keys * (r + dr) * 4 + (k_up.numel() + v_up.numel()) * 4 \
            + (q.numel() + got.numel() + tab.numel()) * 4
        # the absorbed form: q . k_up per query row; a (R + Dr)-wide score
        # and an R-wide weighted sum per visible (query, key) and head;
        # v_up per query row
        pairs = int(vis.sum()) * h
        gemm_ops = 2 * rows * nope * r + 2 * rows * r * dv
        walk_ops = pairs * (2 * (r + dr) + 2 * r)
        # both walks multiply on tensor cores in 3xTF32; the GEMMs too on
        # the tiled route, in float32 on CUDA cores on the decode route
        row["bound_rate"] = ("3xTF32, 495/3 TFLOP/s" if tiled else
                             "GEMMs float32 67 TFLOP/s, walk 3xTF32 "
                             "495/3 TFLOP/s")
        gemm_rate = TF32X3_FLOPS_PER_S if tiled else FP32_FLOPS_PER_S
        row["bound_ms"], row["bound_by"] = bound_ms(
            n_bytes, gemm_ops + walk_ops, (gemm_ops + walk_ops) / (
                gemm_ops / gemm_rate + walk_ops / TF32X3_FLOPS_PER_S))
        run = lambda: pa.paged_attention_mla(q, ckv, krope, tab, **kw)
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["launch_ms"] = launch_ms(run)
        check_bound(row, "paged_attention_mla")
        row["plain_ms"] = time_ms(
            lambda: pa.paged_attention_mla_torch(q, ckv, krope, tab, **kw),
            iters=3)
        lat = ckv[tab.long()].reshape(b, mb * bs, r)
        rope = krope[tab.long()].reshape(b, mb * bs, dr)
        mask = vis[:, None].expand(b, h, c, mb * bs)
        fsdpa = torch.nn.functional.scaled_dot_product_attention
        scale = (nope + dr) ** -0.5
        # the library yardstick: the absorbed form in PyTorch calls —
        # torch.matmul of q_nope by each head's k_up, SDPA over the
        # gathered latents as keys (R + Dr wide) and values (R wide),
        # every head's query rows against the row's one latent sequence,
        # torch.matmul by each head's v_up (weights laid out per head
        # once, outside the timing)
        k_up_h = k_up.reshape(r, h, nope).permute(1, 2, 0).contiguous()
        v_up_h = v_up.reshape(r, h, dv).permute(1, 0, 2).contiguous()
        keys = torch.cat([lat, rope], dim=-1)[:, None]  # (B, 1, S, R + Dr)
        vals = lat[:, None]                              # (B, 1, S, R)
        mask_hc = mask.reshape(b, 1, h * c, mb * bs)

        def library():
            qn = q[..., :nope].permute(2, 0, 1, 3).reshape(h, b * c, nope)
            q_lat = torch.matmul(qn, k_up_h)            # (H, B*C, R)
            qa = torch.cat([q_lat.reshape(h, b, c, r).permute(1, 0, 2, 3),
                            q[..., nope:].transpose(1, 2)], dim=-1)
            o = fsdpa(qa.reshape(b, 1, h * c, r + dr), keys, vals,
                      attn_mask=mask_hc, scale=scale)
            o = o.reshape(b, h, c, r).permute(1, 0, 2, 3).reshape(h, b * c, r)
            return torch.matmul(o, v_up_h)              # (H, B*C, Dv)
        lib_out = library().reshape(h, b, c, dv).permute(1, 2, 0, 3)
        if not (lib_out - want).abs().max().item() <= 10 * limit:
            raise AssertionError("the absorbed library yardstick computes "
                                 "another function than the plain version")
        row["library_ms"] = time_ms(library)
        row["library"] = ("absorbed: matmul by k_up + SDPA over the latents "
                          "+ matmul by v_up")

        # the decompressing yardstick: both expansion matmuls of every
        # gathered key, then SDPA over per-head K and V
        rope_h = rope[:, :, None].expand(b, mb * bs, h, dr)
        qt = q.transpose(1, 2)

        def decompress():
            k_nope = torch.matmul(lat, k_up).reshape(b, mb * bs, h, nope)
            v_h = torch.matmul(lat, v_up).reshape(b, mb * bs, h, dv)
            k_h = torch.cat([k_nope, rope_h], dim=-1)
            return fsdpa(qt, k_h.transpose(1, 2), v_h.transpose(1, 2),
                         attn_mask=mask)
        row["library_decompress_ms"] = time_ms(decompress)
    return row


def phase_attention_variants(dev) -> dict[str, list[dict]]:
    """The ring and MLA variants at the published shapes of their
    configurations, each against its plain version, timed."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {"paged_attention_ring": [check_ring_attention(dev, c, gen, True)
                                     for c in (1, 128)]
            # the engine's smallest decode bucket: one wrapped row
            + [check_ring_attention(dev, 1, gen, True, newest=(6000,))],
            "paged_attention_mla": [check_mla_attention(dev, c, gen, True)
                                    for c in (1, 128)]}
    rows["paged_attention_mla"].append(check_mla_attention(dev, 1, gen, True,
                                                           ring=True))
    # the engine's smallest decode bucket: one row at kv_len 1024
    rows["paged_attention_mla"].append(check_mla_attention(dev, 1, gen, True,
                                                           lens=(1024,)))
    # off the paths, checked untimed: a ring prefill chunk of MLA; ring
    # chunks around the decode and prefill tiles (G = 4: R = 16, 20, 68),
    # rings that have just wrapped (newest = capacity - 1, capacity,
    # capacity + 1, + one block), a window that cuts a block and a key
    # tile mid-way
    check_mla_attention(dev, 5, gen, False, ring=True)
    # the MLA decode walk's parts: kv_len one short of, at and one past a
    # part boundary (k * MLA_PART_KEYS), 0, 1 and BS - 1, with and
    # without a window that cuts a part; rings whose arc starts one
    # short of, at and one past a part boundary, and wraps (at a
    # multiple of the 1024-slot capacity: a part boundary)
    from repro_torch.kernels.paged_attention import MLA_PART_KEYS as mk
    edges = (mk - 1, mk, mk + 1, 3 * mk - 1, 3 * mk, 3 * mk + 1, 0, 1, 15)
    for window in (None, 100):
        check_mla_attention(dev, 1, gen, False, window=window, lens=edges)
        check_mla_attention(dev, 1, gen, False, ring=True, window=window,
                            newest=(1023 + mk - 1, 1023 + mk, 1023 + mk + 1,
                                    2047, 2048, 2049, 1023 + 3 * mk,
                                    3 * 1024 + 5))
    # MLA around the decode block (C * H = 16) and the tiled path's
    # 64-row tile (C = 2, 4, 5, 17 at H = 16), a window that cuts a
    # latent block, ring chunks over a ring that has just wrapped
    for c in (2, 4, 5, 17):
        check_mla_attention(dev, c, gen, False)
    check_mla_attention(dev, 17, gen, False, window=37)
    check_mla_attention(dev, 128, gen, False, window=300)
    for c in (17, 128):
        check_mla_attention(dev, c, gen, False, ring=True,
                            newest=(1023, 1024, 1025, 1040, 1024 + 70))
    for c in (4, 5, 17):
        check_ring_attention(dev, c, gen, False)
    for c in (1, 17, 128):
        check_ring_attention(dev, c, gen, False,
                             newest=(4223, 4224, 4225, 4240, 4224 + 70),
                             window=1000)
    # the decode walk's parts over a ring: the arc wraps at position 8448
    # (twice the capacity, a part boundary) and starts one short of, at
    # and one past a part boundary; a window that cuts a part, and one
    # key wide
    for window in (4096, 300):
        check_ring_attention(dev, 1, gen, False, window=window,
                             newest=(8447, 8448, 8449, 8703, 4350, 4351,
                                     4352, 3 * 4224 + 5))
    check_ring_attention(dev, 1, gen, False, window=1,
                         newest=(0, 255, 256, 8448))
    for name, rs in rows.items():
        for r in rs:
            log(f"[kernels] {name} {json.dumps(r)}")
    return rows


# --------------------------------------------------------------- phase 3


def traffic(vocab: int, n_requests: int = 16, prompt_lens=(64, 512),
            seed: int = 0) -> list[np.ndarray]:
    """Seeded prompts with lengths drawn uniformly from ``prompt_lens``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, size=n_requests)
    return [rng.integers(0, vocab, size=n) for n in lens]


SERVING_KERNELS = ("fused_bnn", "paged_attention", "binarize_pack")


def phase_serving(dev, cfg, ecfg, n_requests: int = 16, max_new: int = 64,
                  prompt_lens=(64, 512), late_after: int = 10, seed: int = 0,
                  *, prompts=None, n_late: int | None = None,
                  required=SERVING_KERNELS, watch=None):
    """Serve seeded traffic through the port's Engine; returns the engine,
    its params, the finished outputs, the launch counts and the stats.
    ``prompts`` replaces the drawn traffic; the last ``n_late`` (default
    half) are submitted after ``late_after`` steps.  Kernel launch
    counts are reset just before the engine is built (its weights pack
    on first use); every kernel in ``required`` must have launched.
    ``watch(engine)``, when given, is called on the new engine before
    the first request."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as M
    from repro_torch.serving import Engine
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init(gen, cfg, device=dev)
    if prompts is None:
        prompts = traffic(cfg.vocab, n_requests, prompt_lens, seed)
    n_requests = len(prompts)
    early = n_requests - (n_requests // 2 if n_late is None else n_late)
    ops.reset_launches()
    eng = Engine(params, cfg, ecfg, device=dev)
    if watch is not None:
        watch(eng)
    t0 = time.perf_counter()
    for p in prompts[:early]:
        eng.submit(p, max_new)
    for _ in range(late_after):
        eng.step()
    for p in prompts[early:]:
        eng.submit(p, max_new)
    out = eng.run()
    torch.cuda.synchronize() if dev.type == "cuda" else None
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    st = eng.stats()
    if len(out) != n_requests:
        raise AssertionError(f"{len(out)} of {n_requests} requests finished")
    for rid, seq in out.items():
        r = eng.requests[rid]
        if seq.shape != (r.prompt_len + max_new,) or \
                not ((seq >= 0) & (seq < cfg.vocab)).all():
            raise AssertionError(f"request {rid}: bad output {seq.shape}")
    if st["max_concurrent_decode"] < 2:
        raise AssertionError("fewer than 2 decode rows ever ran together")
    log(f"[serving] {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} "
        f"vocab={cfg.vocab} requests={n_requests} "
        f"prompt_tokens={sum(len(p) for p in prompts)} "
        f"generated={st['decoded_tokens']} steps={st['steps']} wall_s={wall:.3f}")
    log(f"[serving] total_tokens_per_s={st['total_tokens_per_s']:.1f} "
        f"decode_tokens_per_s={st['decode_tokens_per_s']:.1f} "
        f"max_concurrent_decode={st['max_concurrent_decode']} "
        f"preemptions={st['preemptions']} prefill_calls={st['prefill_calls']} "
        f"decode_calls={st['decode_calls']}")
    log(f"[serving] launches {json.dumps(launches)}")
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{cfg.name} serving path")
    return eng, params, out, launches, st


# --------------------------------------------------------------- phase 4

# taps of the inputs of binarized projections (their sign bits are what
# the XNOR GEMM sees)
BNN_TAPS = ("q", "k", "v", "o", "q_down", "q_up", "kv_down", "gate", "up",
            "down", "moe_in", "moe_down_in", "in_proj", "out_proj")


def _check_signs(where, name, a, b, skip_rows=None) -> set[int]:
    """Sign bits of one BNN input, kernel route ``a`` vs plain ``b``
    (rows = chunk positions); a flip is accepted only within
    FLIP_RMS_FRACTION x its row's RMS of zero, and printed.  Returns the
    positions with accepted flips."""
    n = a.shape[0]
    a2, b2 = a.reshape(n, -1, a.shape[-1]), b.reshape(n, -1, b.shape[-1])
    if skip_rows is not None:
        a2, b2 = a2[~skip_rows], b2[~skip_rows]
        pos_of = (~skip_rows).nonzero()[:, 0]
    else:
        pos_of = torch.arange(n, device=a.device)
    diff = (a2 >= 0) != (b2 >= 0)
    if not diff.any():
        return set()
    rms = b2.float().pow(2).mean(dim=-1, keepdim=True).sqrt()
    near = b2.abs() <= FLIP_RMS_FRACTION * rms
    if (diff & ~near).any():
        raise AssertionError(f"{where} {name}: {int((diff & ~near).sum())} "
                             "sign bits differ away from 0")
    flipped = set()
    for i, j, col in diff.nonzero().tolist():
        pos = int(pos_of[i])
        flipped.add(pos)
        v, r = b2[i, j, col].item(), rms[i, j, 0].item()
        log(f"[e2e] {where} {name} pos {pos} col {col}: sign flip at "
            f"{v:.3g} (row rms {r:.3g}: {abs(v) / r:.3g} x rms from 0)")
    return flipped


def _check_sublayer(where, taps_k, taps_p, y_k, y_p) -> tuple[int, float]:
    """One sublayer (attention, or FFN / MoE) run on the same input by
    both routes: the sign bits of every BNN input, the MoE routing
    (a difference accepted only at a near-tie of the plain path's
    router), and the outputs within MAX_HIDDEN_ERR — at the positions
    no accepted flip or routing difference explains.  Returns (accepted
    flips, max output error)."""
    flipped: set[int] = set()
    probs = differs = None
    for (name, a), (name_p, b) in zip(taps_k, taps_p, strict=True):
        if name != name_p:
            raise AssertionError(f"{where}: taps {name} vs {name_p}")
        if name == "router_probs":
            probs = b
        elif name == "topk":
            differs = (a != b).any(dim=-1)
            for pos in differs.nonzero()[:, 0].tolist():
                top = probs[pos].sort(descending=True).values
                k = a.shape[-1]
                gap = (top[k - 1] - top[k]).item()
                if not gap < MAX_ROUTE_GAP:
                    raise AssertionError(
                        f"{where} pos {pos}: experts {a[pos].tolist()} vs "
                        f"{b[pos].tolist()} with router gap {gap:.3g}")
                log(f"[e2e] {where} pos {pos}: routing {a[pos].tolist()} vs "
                    f"{b[pos].tolist()} at a router near-tie (gap {gap:.3g})")
                flipped.add(pos)
        elif name in BNN_TAPS:
            skip = differs if name == "moe_down_in" else None
            flipped |= _check_signs(where, name, a, b, skip)
    ok = torch.ones(y_k.shape[0], dtype=torch.bool, device=y_k.device)
    ok[list(flipped)] = False
    err = (y_k[ok] - y_p[ok]).abs().max().item() if ok.any() else 0.0
    if not err <= MAX_HIDDEN_ERR:
        raise AssertionError(f"{where}: output differs by {err:.3g}")
    return len(flipped), err


ROUTES = ("auto", "torch")      # the kernels, the plain versions


def _two_routes(where, mix_step, ffn_step, keep=None):
    """One layer on both routes, re-synchronised at each sublayer:
    ``mix_step(route, taps)`` and ``ffn_step(route, xm, taps)`` run the
    mixer and the FFN / MoE sublayer (with its residual); both routes
    take the kernel route's input.  ``keep(label, taps, y)`` receives
    the kernel route's taps and output of each sublayer.  Returns
    (kernel route's layer output, plain route's, accepted flips, worst
    output error); each tap and output is (rows, ...) over the checked
    rows."""
    flips, worst = 0, 0.0
    ys, taps = {}, {}
    for r in ROUTES:
        taps[r] = []
        ys[r] = mix_step(r, taps[r])
    nf, err = _check_sublayer(f"{where} attn", taps["auto"], taps["torch"],
                              ys["auto"][1], ys["torch"][1])
    flips, worst = flips + nf, max(worst, err)
    if keep:
        keep("attn", taps["auto"], ys["auto"][1])
    outs, ftaps = {}, {}
    for r in ROUTES:
        ftaps[r] = []
        outs[r] = ffn_step(r, ys["auto"][0], ftaps[r])
    nf, err = _check_sublayer(f"{where} ffn", ftaps["auto"], ftaps["torch"],
                              outs["auto"][1], outs["torch"][1])
    flips, worst = flips + nf, max(worst, err)
    if keep:
        keep("ffn", ftaps["auto"], outs["auto"][1])
    return outs["auto"][0], outs["torch"][0], flips, worst


def _teacher_forced(params, cfg, seq: np.ndarray, chunk: int, bs: int,
                    ring_blocks: int, dev, where: str, keep_from: int):
    """Prefill ``seq`` in chunks through the kernels ("auto") and the
    plain versions ("torch") on fresh pools, layer by layer and
    re-synchronised at every sublayer: both routes run each attention
    and each FFN / MoE on the kernel route's input, so a difference is
    held to the sublayer that made it.  Returns (kernel route's logits
    (T, V), plain route's logits, accepted flips, worst output error,
    the kernel route's sublayers at positions >= ``keep_from``:
    {position: [(label, taps, output)]})."""
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    t = len(seq)
    # a ring table is exactly the ring wide: positions wrap modulo it;
    # SSM layers run in recurrent slot 1
    mb = ring_blocks or -(-t // bs)
    pools = {r: M.init_paged_state(cfg, mb + 1, bs, 2, device=dev)
             for r in ROUTES}
    table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)[None]
    slots = torch.ones(1, dtype=torch.int32, device=dev)
    logits = {r: [] for r in ROUTES}
    kept: dict[int, list] = {}
    flips, worst = 0, 0.0
    with torch.no_grad():
        for pos in range(0, t, chunk):
            n = min(chunk, t - pos)
            toks = torch.zeros((1, chunk), dtype=torch.int64, device=dev)
            toks[0, :n] = torch.from_numpy(seq[pos:pos + n].astype(np.int64))
            lengths = torch.tensor([pos], dtype=torch.int32, device=dev)
            n_valid = torch.tensor([n], dtype=torch.int32, device=dev)
            x = M._embed(params, cfg, toks)
            for li, (mix, f, p) in enumerate(M._iter_layers(cfg, params)):
                h = C.norm(x, p["norm1"], cfg.norm, cfg.norm_eps)

                def mix_step(r, taps, li=li, mix=mix, p=p, h=h):
                    y = M.mixer_prefill(
                        mix, p["attn"], cfg, h, pools[r][li], table, lengths,
                        n_valid, slots, ring=bool(ring_blocks), impl=r,
                        taps=taps)
                    taps[:] = [(nm, v[0, :n]) for nm, v in taps]
                    return x + y, y[0, :n]

                def ffn_step(r, xm, taps, f=f, p=p):
                    y = M._ffn(p, cfg, f, xm, r, paged=True, taps=taps)
                    taps[:] = [(nm, v[0, :n]) for nm, v in taps]
                    return y, y[0, :n]

                def keep(label, taps, y, li=li):
                    for i in range(max(0, keep_from - pos), n):
                        kept.setdefault(pos + i, []).append(
                            (f"layer {li} {label}",
                             [(nm, v[i:i + 1]) for nm, v in taps],
                             y[i:i + 1]))
                x, xp, nf, err = _two_routes(
                    f"{where} pos {pos} layer {li}", mix_step, ffn_step,
                    keep if pos + n > keep_from else None)
                flips, worst = flips + nf, max(worst, err)
            for r, v in (("auto", x), ("torch", xp)):
                v = C.norm(v, params["final_norm"], cfg.norm, cfg.norm_eps)
                logits[r].append(torch.matmul(v, params["head"]["w"])[0, :n])
    return (torch.cat(logits["auto"]), torch.cat(logits["torch"]), flips,
            worst, kept)


def engine_calls(eng, rid: int) -> list[tuple]:
    """The step calls that made request ``rid``'s output, from the
    scheduler's trace after its last admission (recompute preemption
    starts a request over): ("prefill", position, tokens) chunks, then
    ("decode", row, batch) steps, each at the row and padded batch the
    engine gave it."""
    trace = eng.scheduler.trace
    start = max(i for i, e in enumerate(trace)
                if e["event"] == "admit" and e["rid"] == rid)
    calls = []
    for e in trace[start:]:
        if e["event"] == "prefill" and e["rid"] == rid:
            calls.append(("prefill", e["pos"] - e["tokens"], e["tokens"]))
        elif e["event"] == "decode" and rid in e["rids"]:
            calls.append(("decode", e["rids"].index(rid), e["batch"]))
    return calls


def engine_slot(eng, rid: int) -> int:
    """The recurrent slot the engine gave request ``rid`` at its last
    admission (0 for a stack without SSM layers)."""
    return [e["slot"] for e in eng.scheduler.trace
            if e["event"] == "admit" and e["rid"] == rid][-1] or 0


def decode_replay(params, cfg, eng, rid: int, dev, where: str,
                  blocks=None):
    """Re-run request ``rid`` as the engine ran it: the prompt in the
    engine's prefill chunks through the kernels (the chunked re-check
    holds the same chunks against the plain versions), then every
    generated position as a C = 1 ``paged_decode_step`` at the engine's
    row, padded batch, table width and recurrent slot (the other rows
    copy the request, inactive), and, given the physical ``blocks`` it
    held, over a pool of the engine's size in those blocks (else blocks
    1.. of a pool of the table's width), through the kernels and the
    plain versions layer by layer,
    re-synchronised at every sublayer as in ``_teacher_forced``; the
    plain route starts from the kernel route's cache.  Every kernel sees
    the shapes the engine gave it, so the kernel route reproduces the
    engine's tokens exactly.
    Returns (greedy tokens of the kernel route, accepted flips, worst
    output error, the kernel route's decode sublayers {position:
    [(label, taps, output)]})."""
    from repro_torch.layers import common as C
    from repro_torch.models import transformer as M
    req = eng.requests[rid]
    seq = req.full_sequence()
    ecfg, ring = eng.ecfg, bool(eng.cache.ring_blocks)
    chunk, bs = ecfg.prefill_chunk, ecfg.block_size
    mb = eng.cache.table_width
    slot = engine_slot(eng, rid)
    calls = engine_calls(eng, rid)
    if sum(c[0] == "decode" for c in calls) != len(req.out) - 1:
        raise AssertionError(f"{where}: {len(req.out)} tokens from "
                             f"{len(calls)} engine calls")
    if blocks is None:
        n_blocks = mb + 1
        row_table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)
    else:                          # the engine's table row: 0 past blocks
        n_blocks = ecfg.num_blocks
        row_table = torch.zeros(mb, dtype=torch.int32, device=dev)
        row_table[:len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
    pools = {"auto": M.init_paged_state(cfg, n_blocks, bs, slot + 1,
                                        device=dev)}
    tokens, kept = [], {}
    flips, worst = 0, 0.0
    pos = 0
    with torch.no_grad():
        for kind, a, n in calls:
            if kind == "prefill":          # a = position, n = tokens
                if a != pos:
                    raise AssertionError(f"{where}: prefill at {a}, "
                                         f"expected {pos}")
                toks = torch.zeros((1, chunk), dtype=torch.int64, device=dev)
                toks[0, :n] = torch.from_numpy(seq[a:a + n].astype(np.int64))
                logits, _ = M.prefill_chunk(
                    params, cfg, toks, pools["auto"], row_table[None],
                    torch.tensor([a], dtype=torch.int32, device=dev),
                    torch.tensor([n], dtype=torch.int32, device=dev),
                    torch.tensor([slot], dtype=torch.int32, device=dev),
                    ring=ring, impl="auto")
                tokens.append(int(logits[0, n - 1].argmax()))
                pos += n
                continue
            if "torch" not in pools:       # the plain route's cache
                pools["torch"] = [{k: v.clone() for k, v in layer.items()}
                                  for layer in pools["auto"]]
            bsz, row = n, a                # a = row, n = padded batch
            toks = torch.full((bsz, 1), int(seq[pos]), dtype=torch.int64,
                              device=dev)
            active = torch.zeros(bsz, dtype=torch.bool, device=dev)
            active[row] = True
            table = row_table[None].expand(bsz, mb).contiguous()
            lengths = torch.full((bsz,), pos, dtype=torch.int32, device=dev)
            slots = torch.full((bsz,), slot, dtype=torch.int32, device=dev)
            x = M._embed(params, cfg, toks)
            for li, (mix, f, p) in enumerate(M._iter_layers(cfg, params)):
                h = C.norm(x, p["norm1"], cfg.norm, cfg.norm_eps)

                def mix_step(r, taps, li=li, mix=mix, p=p, h=h):
                    y = M.mixer_decode(
                        mix, p["attn"], cfg, h, pools[r][li], table, lengths,
                        slots, active, ring=ring, impl=r, taps=taps)
                    taps[:] = [(nm, v[row]) for nm, v in taps]
                    return x + y, y[row]

                def ffn_step(r, xm, taps, f=f, p=p):
                    y = M._ffn(p, cfg, f, xm, r, paged=True, taps=taps)
                    taps[:] = [(nm, v[row]) for nm, v in taps]
                    return y, y[row]

                def keep(label, taps, y, li=li):
                    kept.setdefault(pos, []).append(
                        (f"layer {li} {label}", taps, y))
                x, _xp, nf, err = _two_routes(
                    f"{where} decode pos {pos} layer {li}", mix_step,
                    ffn_step, keep)
                flips, worst = flips + nf, max(worst, err)
            v = C.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
            logits = torch.matmul(v, params["head"]["w"])
            tokens.append(int(logits[row, 0].argmax()))
            pos += 1
    # the prefill's token completes the prompt; each decode makes one more
    return (np.asarray(tokens[len(tokens) - len(req.out):]), flips, worst,
            kept)


def _cross_check(where, kept_replay, kept_chunked, chunk_path) -> int | None:
    """The decode replay against the chunked re-check, kernel route
    against kernel route, sublayer by sublayer in position order: the
    first sublayer where the two part must be a difference that
    ``_check_sublayer`` accepts (a sign flip within FLIP_RMS_FRACTION x
    RMS of zero, an MoE routing difference at a router near-tie); it is
    printed with the two routes, and everything after it is downstream
    of it.  Returns the position where they part, or None."""
    for pos in sorted(kept_replay):
        for (label, taps_r, y_r), (label_c, taps_c, y_c) in zip(
                kept_replay[pos], kept_chunked[pos], strict=True):
            if label != label_c:
                raise AssertionError(f"{where}: {label} vs {label_c}")
            nf, _err = _check_sublayer(
                f"{where} pos {pos} {label} decode replay vs chunked",
                taps_r, taps_c, y_r, y_c)
            if nf:
                log(f"[e2e] {where}: the decode replay (C = 1 decode walk) "
                    f"and the chunked re-check ({chunk_path}) part first at "
                    f"pos {pos} {label}, by an accepted difference printed "
                    "above; later positions are downstream of it")
                return pos
    return None


def _route_gap(kept_replay, kept_chunked) -> tuple[float, int, int]:
    """How far the chunked re-check's BNN inputs are from the replay's at
    the generated positions: (max |difference| / the row's RMS, sign
    flips, flips farther than FLIP_RMS_FRACTION x RMS from 0)."""
    worst, flips, far = 0.0, 0, 0
    for pos in kept_replay:
        for (_l, taps_r, _y), (_l2, taps_c, _y2) in zip(
                kept_replay[pos], kept_chunked[pos], strict=True):
            for (name, a), (_n, b) in zip(taps_r, taps_c, strict=True):
                if name not in BNN_TAPS:
                    continue
                rms = b.float().pow(2).mean().sqrt()
                worst = max(worst, ((a - b).abs().max() / rms).item())
                diff = (a >= 0) != (b >= 0)
                flips += int(diff.sum())
                far += int((diff & (b.abs() > FLIP_RMS_FRACTION * rms)).sum())
    return worst, flips, far


def phase_e2e(dev, cfg, params, eng, out, rids=None, held=None):
    """Two re-checks of finished requests (the first two by default),
    each running the kernels and the plain versions layer by layer: a
    decode replay of what the engine ran, whose kernel route must
    reproduce the engine's greedy tokens exactly, and a teacher-forced
    chunked prefill, which must reproduce them up to the first place
    where it parts from the replay by an accepted difference.
    ``held`` (rid -> the physical blocks the engine gave it) runs the
    replay in the engine's own table.

    The chunked re-check of a stack with SSM layers runs the generated
    positions in the SSD dual form where the engine (and the replay)
    ran the recurrence; how far the two routes' BNN inputs are apart is
    printed (the dual form's decay exp(cum_t - cum_s) is a difference
    of two running sums, so it strays further than attention's rounding
    does)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as M
    flips_total = 0
    chunk = eng.ecfg.prefill_chunk
    mixers = {mix for mix, _f in M.layer_plan(cfg)}
    ssm = "ssm" in mixers
    paths = []
    if "mla" in mixers:
        paths.append("MLA tiled 3xTF32 path" if pa.mla_tiled(
            chunk, cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim)
            else "MLA decode walk")
    if "gqa" in mixers:
        paths.append("GQA tiled path" if pa.gqa_tiled(
            chunk, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
            else "GQA decode walk")
    if ssm:
        paths.append("SSD dual form")
    path = " + ".join(paths) + f", chunks of {chunk}"
    for rid in (sorted(out)[:2] if rids is None else rids):
        req = eng.requests[rid]
        seq = out[rid]
        p = req.prompt_len
        where = f"{cfg.name} rid {rid}"
        t0 = time.perf_counter()
        tok_r, flips, worst_r, kept_r = decode_replay(
            params, cfg, eng, rid, dev, where,
            None if held is None else held[rid])
        replay_s = time.perf_counter() - t0
        flips_total += flips
        if not np.array_equal(tok_r, seq[p:]):
            bad = int((tok_r != seq[p:]).sum())
            raise AssertionError(f"{where}: the decode replay's greedy tokens "
                                 f"differ from the engine's at {bad} "
                                 "positions")
        lg_k, lg_p, flips, worst, kept_c = _teacher_forced(
            params, cfg, seq, chunk, eng.ecfg.block_size,
            eng.cache.ring_blocks, dev, where, keep_from=p)
        flips_total += flips
        if ssm:
            gap, nflip, nfar = _route_gap(kept_r, kept_c)
            log(f"[e2e] {where}: the chunked re-check ({path}) against the "
                f"replay (SSD recurrence) at the generated positions: BNN inputs "
                f"differ by up to {gap:.3g} x RMS, {nflip} sign flips, "
                f"{nfar} of them farther than {FLIP_RMS_FRACTION} x RMS "
                "from 0")
        part = _cross_check(where, kept_r, kept_c, path)
        greedy = lg_k[p - 1:-1].argmax(dim=-1).cpu().numpy()
        # the token at seq[i] comes from the logits at position i - 1
        differ = np.flatnonzero(greedy != seq[p:]) + p - 1
        if differ.size and (part is None or differ.min() < part):
            raise AssertionError(f"{where}: teacher-forced greedy tokens "
                                 f"differ from the engine's at positions "
                                 f"{differ.tolist()}, before any accepted "
                                 "difference from the decode replay")
        lerr = (lg_k - lg_p).abs().max().item()
        if not torch.isfinite(lg_k).all() or not lerr <= MAX_HIDDEN_ERR * 10:
            raise AssertionError(f"{where}: logits differ by {lerr:.3g}")
        log(f"[e2e] {where} tokens={len(seq)} layers={cfg.n_layers} "
            f"slot={engine_slot(eng, rid)} "
            + ("" if held is None else f"blocks={len(held[rid])} ")
            + f"max_sublayer_err={max(worst, worst_r):.3g} "
            f"max_logit_err={lerr:.3g} decode replay reproduces the "
            f"engine's {len(seq) - p} greedy tokens ({replay_s:.2f} s); "
            f"chunked re-check: {len(seq) - p - differ.size} equal"
            + ("" if part is None else
               f", {differ.size} differ after the routes part at pos {part}"))
    log(f"[e2e] {cfg.name} sign flips and routing differences accepted: "
        f"{flips_total}")


# --------------------------------------------------------------- phase 5

def check_xnor_popcount(dev, m: int, n: int, s: int, gen: torch.Generator,
                        timed: bool, modes=MODES, kw: int | None = None,
                        offset: int = 0) -> dict:
    """The packed x packed GEMM kernel against its plain version on
    operands packed from seeded floats (pad bits 0, as the conv path
    packs them), over ``kw`` words (default ceil(s/32); more words are
    zero), ip a view ``offset`` words into its buffer."""
    from repro_torch.kernels import _lib, binarize_pack as bp
    from repro_torch.kernels import xnor_popcount as xp
    x = torch.randn(m, s, device=dev, generator=gen)
    w = torch.randn(n, s, device=dev, generator=gen)
    ip, wp = bp.binarize_pack_torch(x), bp.binarize_pack_torch(w)
    kw = kw or ip.shape[1]
    ip = torch.nn.functional.pad(ip, (0, kw - ip.shape[1]))
    wp = torch.nn.functional.pad(wp, (0, kw - wp.shape[1])).contiguous()
    if offset:
        buf = torch.zeros(m * kw + offset, dtype=torch.int32, device=dev)
        buf[offset:] = ip.reshape(-1)
        ip = buf[offset:].view(m, kw)
    alpha = torch.rand(n, device=dev, generator=gen) + 0.5
    for mode in modes:
        got = xp.xnor_popcount_matmul(ip, wp, s, mode=mode, alpha=alpha)
        want = xp.xnor_popcount_matmul_torch(ip, wp, s, mode=mode, alpha=alpha)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = (got.float() != want.float()).sum().item()
            raise AssertionError(f"xnor_popcount M={m} N={n} S={s} Kw={kw} "
                                 f"offset={offset} {mode}: {bad} elements "
                                 "differ from the plain version")
    plan = xp.xnor_plan(m, n, kw, _lib.sm_count(dev))
    row = {"shape": f"M={m} N={n} S={s}", "max_abs_err": 0.0,
           "plan": list(plan)}
    if timed:
        n_bytes = (m + n) * kw * 4 + m * n * 4          # dot: int32 out
        row["bound_ms"], row["bound_by"] = bound_ms(
            n_bytes, 2 * m * n * s, xnor_gemm_ops_per_s(dev))
        run = lambda: xp.xnor_popcount_matmul(ip, wp, s, mode="dot")
        row["ms"] = time_ms(run)
        row["eager_ms"] = eager_ms(run)
        row["plain_ms"] = time_ms(
            lambda: xp.xnor_popcount_matmul_torch(ip, wp, s, mode="dot"),
            iters=3)
        xs = torch.where(x >= 0, 1.0, -1.0).to(torch.bfloat16)
        ws = torch.where(w >= 0, 1.0, -1.0).to(torch.bfloat16)
        row["library_ms"] = time_ms(lambda: torch.matmul(xs, ws.t()))
        check_bound(row, "xnor_popcount")
    return row


# (Kw, S) of the XNOR GEMM edge checks: a word, 3 and 5 words (not a
# multiple of 4), VGG's 144 and 256; and 8 words over S = 100 (Kw past
# ceil(S/32): zero words)
XNOR_EDGE_K = ((1, 27), (3, 70), (5, 147), (144, 4608), (256, 8192),
               (8, 100))


def check_xnor_edges(dev, gen: torch.Generator) -> None:
    """Bit-exact in four modes around both routes (M = 8 / 9) and the
    tensor-core tile (64 / 65 rows), at N around the column tiles, K
    around word and vector widths; ip at an odd word offset (1-word
    copies); every route of ``xnor_plan`` at least once."""
    plans = set()
    for m in (1, 8, 9, 49, 64, 65):
        for kw, s in XNOR_EDGE_K:
            for n in (10, 77, 1000):
                r = check_xnor_popcount(dev, m, n, s, gen, False, kw=kw)
                plans.add((*r["plan"][:2], r["plan"][2] > 1))
    for m, n, kw, s in ((1, 1000, 144, 4608), (9, 77, 5, 147),
                        (64, 512, 144, 4608), (65, 77, 256, 8192),
                        (8449, 96, 10, 300)):
        r = check_xnor_popcount(dev, m, n, s, gen, False, kw=kw, offset=1)
        plans.add((*r["plan"][:2], r["plan"][2] > 1))
    # (route, tile width, split): weight read, CUDA-core tiles, binary
    # mma tiles 32 and 64 wide, split K
    want = {(0, 0, False), (1, 0, False), (2, 32, False), (2, 32, True),
            (2, 64, False)}
    if not want <= plans:
        raise AssertionError(f"xnor_popcount edges took routes {plans}, "
                             f"not all of {want}")
    log(f"[conv] xnor_popcount edges bit-exact in four modes; routes "
        f"(route, bn, split) {sorted(plans)}")


def conv_layers() -> list[tuple[str, object]]:
    """(network, LayerSpec) of every groups == 1 layer of the four BNNs:
    convs, 1x1 convs and the fully connected layers (1x1 over 1x1)."""
    from repro_torch.photonic import workloads as wl
    return [(net, layer) for net, make in wl.WORKLOADS.items()
            for layer in make() if layer.groups == 1]


def conv_args(layer) -> dict:
    """A LayerSpec's stride and padding: 'pad=0' layers are VALID, the
    rest SAME (JAX's SAME gives the published output sizes)."""
    return {"stride": layer.stride,
            "padding": "VALID" if layer.pad == 0 else "SAME"}


def _pool2(a: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of NHWC {0,1} activations (an OR; the same in the
    {-1,+1} encoding), as VGG-small pools between its conv stages."""
    b, h, w, c = a.shape
    return a.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def phase_conv(dev) -> tuple[dict, dict[str, int]]:
    """Checks and times the conv path; returns the rows for the kernel
    table and the launch counts of the run over every layer."""
    from repro_torch.core import conv, patches
    from repro_torch.core.binarize import b01_to_pm1
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(1)
    layers = conv_layers()
    cases = []
    for net, layer in layers:
        x = torch.randn(1, layer.h_in, layer.w_in, layer.c_in, device=dev,
                        generator=gen)
        w = torch.randn(layer.k, layer.k, layer.c_in, layer.c_out,
                        device=dev, generator=gen)
        cases.append((net, layer, x, w))
    shapes = sorted({(l.h_out * l.w_out, l.c_out, l.s) for _, l in layers})
    log(f"[conv] {len(layers)} ungrouped layers, {len(shapes)} distinct "
        f"GEMM shapes (M, N, S)")

    # 1. the GEMM kernel against its plain version: edges, then every
    # distinct layer shape (four modes, timed in "dot")
    check_xnor_edges(dev, gen)
    gemm = {}
    for m, n, s in shapes:
        gemm[(m, n, s)] = check_xnor_popcount(dev, m, n, s, gen, True)
        log(f"[conv] xnor_popcount {json.dumps(gemm[(m, n, s)])}")

    # 2. packing at the patch shapes (M, S) and the weight shapes (N, S);
    # the patch rows packed from each distinct layer input, and at
    # thresholds that tell the two padding rules apart (a padded tap is
    # 0.0, a position past S -1.0) on a C_in that is no multiple of 4
    packs = {}
    for m, n, s in shapes:
        for rows in (m, n):
            if (rows, s) not in packs:
                packs[(rows, s)] = check_binarize_pack(dev, rows, s, gen, True)
                log(f"[conv] binarize_pack {json.dumps(packs[(rows, s)])}")
    patch_rows = {}
    for net, layer, x, _w in cases:
        key = (tuple(x.shape), layer.k, *conv_args(layer).values())
        if key not in patch_rows:
            patch_rows[key] = {"layer": f"{net}.{layer.name}",
                               **check_pack_patches(dev, x, layer.k,
                                                    **conv_args(layer),
                                                    timed=True)}
            log(f"[conv] pack_patches {json.dumps(patch_rows[key])}")
    xe = torch.randn(2, 9, 7, 5, device=dev, generator=gen)
    for thr in (-2.0, -0.5, 0.5):
        for k, stride, padding in ((3, 2, "SAME"), (3, 1, "VALID"),
                                   (1, 1, "SAME")):
            check_pack_patches(dev, xe, k, stride, padding, False, thr)
            check_pack_patches(dev, xe[..., :4].contiguous(), k, stride,
                               padding, False, thr)

    # 3. the main path: every layer through bnn_conv2d on the card
    ops.reset_launches()
    outs = [conv.bnn_conv2d(x, w, **conv_args(layer))
            for _, layer, x, w in cases]
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in ops.KERNELS}
    log(f"[conv] launches {json.dumps(launches)}")
    for name in ("binarize_pack", "pack_patches", "xnor_popcount"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the conv path")
    nets: dict[str, dict] = {}      # per network: summed device times
    for (net, layer, x, w), got in zip(cases, outs, strict=True):
        args = conv_args(layer)
        want_shape = (1, layer.h_out, layer.w_out, layer.c_out)
        if tuple(got.shape) != want_shape or not torch.isfinite(got).all():
            raise AssertionError(f"{net}.{layer.name}: output {tuple(got.shape)}"
                                 f", want finite {want_shape}")
        plain = conv.bnn_conv2d(x, w, impl="torch", **args)
        oracle = conv.reference_sign_conv2d(x, w, **args)
        for what, ref in (("plain path", plain), ("sign-conv oracle", oracle)):
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise AssertionError(f"{net}.{layer.name}: {bad} outputs "
                                     f"differ from the {what}")
        m, n, s = layer.h_out * layer.w_out, layer.c_out, layer.s
        g = gemm[(m, n, s)]
        # the library yardstick: cuDNN's bf16 conv of the sign tensors,
        # NCHW/OIHW, padded as JAX pads
        xs = patches.pad(torch.where(x >= 0, 1.0, -1.0), layer.k, layer.k,
                         **args)
        xs = xs.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
        ws = torch.where(w >= 0, 1.0, -1.0).permute(3, 2, 0, 1)
        ws = ws.to(torch.bfloat16).contiguous()
        row = {"layer": f"{net}.{layer.name}", "M": m, "N": n, "S": s,
               "gemm_ms": g["ms"], "bound_ms": g["bound_ms"],
               "bound_by": g["bound_by"], "gemm_plain_ms": g["plain_ms"],
               "layer_ms": time_ms(lambda: conv.bnn_conv2d(x, w, **args)),
               "library_ms": time_ms(lambda: torch.nn.functional.conv2d(
                   xs, ws, stride=layer.stride))}
        log(f"[conv] layer {json.dumps(row)}")
        tot = nets.setdefault(net, dict.fromkeys(
            ("layers", "layer_ms", "gemm_ms", "library_ms", "bound_ms"), 0))
        tot["layers"] += 1
        for k in ("layer_ms", "gemm_ms", "library_ms", "bound_ms"):
            tot[k] += row[k]
    for net, tot in nets.items():
        log(f"[conv] network {net} {json.dumps(tot)}")

    # 4. a chained binary stack: VGG-small conv2..conv6, each layer's
    # comparator output fed on as {-1,+1} (pooled where the stage halves)
    chain = [(layer, w) for net, layer, _x, w in cases
             if net == "vgg_small" and layer.name in
             ("conv2", "conv3", "conv4", "conv5", "conv6")]
    x0 = torch.randn(1, 32, 32, 128, device=dev, generator=gen)
    acts = {"kernels": x0, "plain": x0, "oracle": x0}
    for layer, w in chain:
        args = conv_args(layer)
        for route, a in acts.items():
            if a.shape[1] > layer.h_in:
                a = _pool2(a)
            a = a if a.is_floating_point() else b01_to_pm1(a)
            if route == "oracle":
                acts[route] = (conv.reference_sign_conv2d(a, w, **args) > 0
                               ).to(torch.uint8)
            else:
                acts[route] = conv.bnn_conv2d(
                    a, w, impl="auto" if route == "kernels" else "torch",
                    binary_out=True, **args)
        if not (torch.equal(acts["kernels"], acts["plain"])
                and torch.equal(acts["kernels"], acts["oracle"])):
            raise AssertionError(f"binary chain differs at vgg_small."
                                 f"{layer.name}")
    final = acts["kernels"]
    log(f"[conv] binary chain vgg_small conv2..conv6: output "
        f"{tuple(final.shape)}, {int(final.sum())} of {final.numel()} "
        f"activations set, equal on kernels, plain and oracle routes")
    return {"xnor_popcount": list(gemm.values()),
            "xnor_popcount_most_work": gemm[max(gemm, key=math.prod)],
            "binarize_pack_conv": list(packs.values()),
            "pack_patches": list(patch_rows.values())}, launches


# --------------------------------------------------------------- phase 6


def phase_photonic(st: dict):
    """Modelled numbers of the photonic accelerators (the paper's
    simulator), printed beside the card's measurements, never as
    them."""
    from repro_torch.photonic import accelerators as acc, simulator as sim
    log(f"[photonic] modelled (not measured on this card) OXBNN cost of the "
        f"served stream: {json.dumps(st['photonic'])}")
    table = sim.compare(acc.ALL)
    nets = list(next(iter(table.values())))
    for net in nets:
        log(f"[photonic] modelled Fig. 7 {net}: " + "; ".join(
            f"{a} fps={table[a][net].fps:.1f} fps/W={table[a][net].fps_per_w:.1f}"
            for a in table))
    g = {a: (sim.gmean([table[a][n].fps for n in nets]),
             sim.gmean([table[a][n].fps_per_w for n in nets])) for a in table}
    ox = g["OXBNN_50"]
    log("[photonic] modelled gmean OXBNN_50 over: " + "; ".join(
        f"{a} fps x{ox[0] / g[a][0]:.2f} fps/W x{ox[1] / g[a][1]:.2f}"
        for a in g if a != "OXBNN_50"))


# --------------------------------------------------------------- phase 7


MIXTRAL_ENGINE = dict(block_size=16, num_blocks=1025, max_batch=8,
                      prefill_chunk=128, max_model_len=8192)
DEEPSEEK_ENGINE = dict(block_size=16, num_blocks=1025, max_batch=8,
                       prefill_chunk=128, max_model_len=1024)
# 5 allocatable recurrent slots under a batch of 8: admissions wait for a
# slot, and released slots are handed out again
MAMBA2_ENGINE = dict(max_batch=8, num_slots=6, prefill_chunk=128,
                     max_model_len=2048)
# jamba: 5 slots under a batch of 8 and a block pool of 256 blocks (4096
# tokens) under 12 prompts of 16-1500 tokens: admissions wait for a slot
# with blocks free, and find a slot but too few blocks
JAMBA_ENGINE = dict(block_size=16, num_blocks=257, max_batch=8, num_slots=6,
                    prefill_chunk=128, max_model_len=2048)
JAMBA_PUBLISHED_LAYERS = (2, 5)      # the served window of the 72 layers


def jamba_window(cfg):
    """jamba-1.5-large cut to published layers 2-4, (ssm, dense), (gqa,
    moe), (ssm, dense): every width as published, one full-width
    16-expert MoE layer (two would not fit on one 80 GB card in
    float32), SSD layers on both sides of the attention layer."""
    lo, hi = JAMBA_PUBLISHED_LAYERS
    return cfg.replace(n_layers=hi - lo, attn_offset=cfg.attn_offset - lo,
                       scan_period=hi - lo)


def jamba_traffic(vocab: int):
    return family_traffic(vocab, seed=3, n=12, lens=(16, 1500))


def family_traffic(vocab: int, long_lens=(), seed: int = 0, n: int = 8,
                   lens=(64, 512)):
    """``n`` seeded prompts: ``long_lens`` first and fifth (one early,
    one late), the rest ``lens[0]``-``lens[1]`` tokens."""
    rng = np.random.default_rng(seed)
    sizes = list(rng.integers(lens[0], lens[1] + 1, size=n - len(long_lens)))
    for i, m in zip((0, 4), long_lens):
        sizes.insert(i, m)
    return [rng.integers(0, vocab, size=int(m)) for m in sizes]


def slot_owners(eng) -> dict[int, list[int]]:
    """Recurrent slot -> the requests admitted to it, in order."""
    owners: dict[int, list[int]] = {}
    for e in eng.scheduler.trace:
        if e["event"] == "admit" and e["slot"] is not None:
            owners.setdefault(e["slot"], []).append(e["rid"])
    return owners


def mamba2_rids(eng, out, _rec=None) -> list[int]:
    """The longest request and the first one admitted to a slot another
    request had released."""
    reused = [rids[1] for rids in slot_owners(eng).values() if len(rids) > 1]
    if not reused:
        raise AssertionError("no recurrent slot was handed out twice")
    longest = max(out, key=lambda r: len(out[r]))
    return [longest] + [min(r for r in reused if r != longest)]


def watch_admissions(eng) -> dict:
    """Record a hybrid engine's admissions (a recurrent slot and the
    prompt's blocks) at its cache: for every attempt the request, its
    outcome, the blocks its prompt needs, both members' free counts
    before and after, and the request's position and slot after it
    (``attempts``); at every release the blocks the request held
    (``held``: its last release is at its finish)."""
    cache = eng.cache
    rec = {"attempts": [], "held": {}}
    alloc, release = cache.alloc_prompt, cache.release

    def free():
        return {"slots": cache.ssm.allocator.num_free,
                "blocks": cache.attn.allocator.num_free}

    def alloc_prompt(req):
        before = free()
        ok = alloc(req)
        rec["attempts"].append({
            "rid": req.rid, "ok": ok,
            "blocks_needed": cache.attn.blocks_needed(req.prompt_len),
            "free_before": before, "free_after": free(), "pos": req.pos,
            "slot": req.slot})
        return ok

    def release_(req):
        rec["held"][req.rid] = list(req.blocks)
        release(req)

    cache.alloc_prompt, cache.release = alloc_prompt, release_
    return rec


def shortages(eng, rec) -> tuple[list[dict], list[dict]]:
    """From the recorded admissions of a hybrid engine: (the attempts
    that waited for a slot while the prompt's blocks were free, the
    attempts that found a free slot but too few blocks, and gave the
    slot back: both members' free counts as before, the request at
    position 0 without a slot).  Every failed attempt must be one of
    the scheduler's ``no_blocks`` defers."""
    failed = [a for a in rec["attempts"] if not a["ok"]]
    defers = [e["rid"] for e in eng.scheduler.trace
              if e["event"] == "defer" and e["reason"] == "no_blocks"]
    if [a["rid"] for a in failed] != defers:
        raise AssertionError("the failed admissions are not the trace's "
                             "no_blocks defers")
    slot_waits = [a for a in failed if a["free_before"]["slots"] == 0
                  and a["free_before"]["blocks"] >= a["blocks_needed"]]
    released = [a for a in failed if a["free_before"]["slots"] > 0
                and a["free_before"]["blocks"] < a["blocks_needed"]
                and a["free_after"] == a["free_before"]
                and a["pos"] == 0 and a["slot"] is None]
    return slot_waits, released


def phase_family(dev, smi: str, cfg, depth: str, ecfg, prompts, required,
                 e2e_rids):
    """Serve one model family at its published widths (``cfg``, its
    depth cut as ``depth`` says) and re-check the finished requests
    ``e2e_rids(eng, out, rec)`` picks layer by layer; returns the
    serving run's launch counts.  A ring must wrap; recurrent slots must
    all be in use at once, and an admission must wait for one.  A
    hybrid stack's admissions (slots and blocks) are recorded (``rec``,
    from ``watch_admissions``): one must wait for a slot while the
    blocks are free, one must find a slot but too few blocks and give
    the slot back, and the replay runs in the engine's own table."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {}

    def watch(eng):
        if eng.cache.attn is not None and eng.cache.ssm is not None:
            rec.update(watch_admissions(eng))
    eng, params, out, launches, st = phase_serving(
        dev, cfg, ecfg, max_new=32, late_after=4, prompts=prompts, n_late=4,
        required=required, watch=watch)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    arch, mixer, layout = cfg.name, st["mixer"], []
    if "blocks" in mixer:
        blk = mixer["blocks"]
        if eng.cache.ring_blocks and not blk["ring_reuses"] > 0:
            raise AssertionError(f"{arch}: the ring never wrapped")
        layout.append(f"blocks={json.dumps(blk)}")
    if "slots" in mixer:
        sl = mixer["slots"]
        if sl["peak_used_slots"] != sl["num_slots"]:
            raise AssertionError(f"{arch}: {sl['peak_used_slots']} of "
                                 f"{sl['num_slots']} slots ever in use")
        if rec:
            slot_waits, released = shortages(eng, rec)
            if not released:
                raise AssertionError(f"{arch}: no admission found a slot "
                                     "but too few blocks")
            waits = len(slot_waits)
            layout.append(
                f"admissions_giving_back_a_slot={len(released)} "
                f"(rids {sorted({a['rid'] for a in released})}; first "
                f"{json.dumps(released[0])})")
        else:                          # no block pool: every defer waits
            waits = sum(e["event"] == "defer" and e["reason"] == "no_blocks"
                        for e in eng.scheduler.trace)
        if not waits:
            raise AssertionError(f"{arch}: no admission waited for a slot")
        layout.append(f"slots={json.dumps(sl)} "
                      f"admissions_waiting_for_a_slot={waits} "
                      f"slot_owners={json.dumps(slot_owners(eng))}")
    log(f"[{arch}] {depth} total_tokens_per_s={st['total_tokens_per_s']:.1f} "
        f"decode_tokens_per_s={st['decode_tokens_per_s']:.1f} "
        f"preemptions={st['preemptions']} {' '.join(layout)} "
        f"peak_memory_gib={peak_gib:.2f} card={smi}")
    phase_e2e(dev, cfg, params, eng, out, rids=e2e_rids(eng, out, rec),
              held=rec.get("held"))
    return launches


def jamba_rids(eng, out, rec) -> list[int]:
    """The longest request and the first that found a slot but too few
    blocks."""
    longest = max(out, key=lambda r: len(out[r]))
    _waits, released = shortages(eng, rec)
    return [longest] + [next(a["rid"] for a in released
                             if a["rid"] != longest)]


# -------------------------------------------------------------------- main
# -------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = phase_device()
    cfg = get_config("bnn-lm-100m").replace(precision="bnn")
    rows = phase_kernels(dev, cfg)
    rows.update(phase_attention_variants(dev))
    phase_jamba_kernels(dev, rows)
    ecfg = EngineConfig(block_size=16, num_blocks=1025, max_batch=8,
                        prefill_chunk=128, max_model_len=1024)
    eng, params, out, launches, st = phase_serving(dev, cfg, ecfg)
    phase_e2e(dev, cfg, params, eng, out)
    del eng, params, out
    conv_rows, conv_launches = phase_conv(dev)
    phase_photonic(st)
    # mixtral: 2 prompts longer than its 4224-token ring (one early, one
    # late); the e2e re-check takes the first of them (its ring wrapped)
    # and the shortest request
    cut = "layers={} (published {})"
    mixtral = phase_family(
        dev, smi, get_config("mixtral-8x7b").replace(precision="bnn",
                                                     n_layers=4),
        cut.format(4, 32), EngineConfig(**MIXTRAL_ENGINE),
        family_traffic(32000, (4400, 4700)),
        ("fused_bnn", "paged_attention_ring", "binarize_pack"),
        lambda eng, out, _rec: [0, min(out, key=lambda r: len(out[r]))])
    deepseek = phase_family(
        dev, smi, get_config("deepseek-v2-lite-16b").replace(
            precision="bnn", n_layers=4),
        cut.format(4, 27), EngineConfig(**DEEPSEEK_ENGINE),
        family_traffic(102400, seed=1),
        ("fused_bnn", "paged_attention_mla", "binarize_pack"),
        lambda eng, out, _rec: sorted(out))
    # mamba2 at its published depth: 16 prompts of 16-1500 tokens (most
    # longer than one prefill chunk); the e2e re-check takes the longest
    # and the first request that got a released slot
    mamba2 = phase_family(
        dev, smi, get_config("mamba2-1.3b").replace(precision="bnn"),
        cut.format(48, 48), EngineConfig(**MAMBA2_ENGINE),
        family_traffic(50280, seed=2, n=16, lens=(16, 1500)),
        ("fused_bnn", "binarize_pack"), mamba2_rids)
    # jamba: published layers 2-4 (ssm, dense), (gqa, moe), (ssm, dense)
    # at published width (≈ 52 GB of float32 weights, so everything
    # before is freed first); the e2e re-check takes the longest request
    # and one that found a slot but too few blocks
    full = get_config("jamba-1.5-large-398b")
    lo, hi = JAMBA_PUBLISHED_LAYERS
    jamba = phase_family(
        dev, smi, jamba_window(full.replace(precision="bnn")),
        f"window=layers {lo}-{hi - 1} of {full.n_layers}",
        EngineConfig(**JAMBA_ENGINE), jamba_traffic(full.vocab),
        SERVING_KERNELS, jamba_rids)
    gc.collect()
    rows["xnor_popcount"] = conv_rows["xnor_popcount"]
    rows["binarize_pack"] += conv_rows["binarize_pack_conv"]
    rows["pack_patches"] = conv_rows["pack_patches"]
    # one representative main-path shape per kernel for the summary line
    # (decode projection / decode attention / one weight / the conv
    # layer with the most XNOR work / decode over the ring / MLA
    # decode / the conv input with the most patch bits); every shape is
    # in the [kernels] and [conv] lines above
    pick = {"fused_bnn": rows["fused_bnn"][4],
            "paged_attention": rows["paged_attention"][0],
            "binarize_pack": rows["binarize_pack"][0],
            "xnor_popcount": conv_rows["xnor_popcount_most_work"],
            "paged_attention_ring": rows["paged_attention_ring"][0],
            "paged_attention_mla": rows["paged_attention_mla"][0],
            "pack_patches": max(rows["pack_patches"],
                                key=lambda r: r["M"] * r["S"])}
    paths = {"serving": launches, "conv": conv_launches, "mixtral": mixtral,
             "deepseek": deepseek, "mamba2": mamba2, "jamba": jamba}
    kernels = []
    for k in ops.KERNELS:
        r = pick[k.name]
        by_path = {p: n[k.name] for p, n in paths.items() if n[k.name]}
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in rows[k.name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **({"library": r["library"]} if "library" in r else {})})
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
