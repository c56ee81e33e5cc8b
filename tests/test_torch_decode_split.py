"""The split decode walk of the port's paged GQA / ring attention, and
what guards it, on the CPU.

* The walk's plan (``kernels/paged_attention.decode_parts``): sized from
  the table width alone, never the batch, and its parts cover every
  range of positions a row can see; the constants the CUDA source and
  the wrapper share agree.
* The walk's algorithm, written out in plain PyTorch here (each tile of
  DECODE_ROWS query rows' visible positions [lo, hi], cut into parts of
  DECODE_PART_KEYS, each part's softmax state merged in part order),
  against the plain version ``paged_attention_torch`` on paged tables,
  rings that wrap, windows, part boundaries and blind rows (float32,
  ATOL/RTOL: summation order).
* ``chip_smoke.py``'s decode replay (the e2e phase's first route) on
  the reduced configs of the four served families: on the CPU engine
  with the plain versions it reproduces every finished request's greedy
  tokens exactly, a mixtral request whose ring wraps, requests that
  were preempted and mamba2 requests on reused recurrent slots
  included; the whole e2e phase (both routes and their cross-check)
  holds on the CPU too.
* The launcher: ``_lib.launch`` calls under the tensors' device and on
  that device's current stream (CUDA stubbed); the merge's counters.
* ``chip_profile.py`` counts every ``__global__`` kernel of the sources
  as the port's own.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain version."""
import contextlib
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _lib, paged_attention as pa
from repro_torch.models import transformer as M
from repro_torch.serving import Engine, EngineConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-5          # float32 attention: reduction-order rounding
CPU = torch.device("cpu")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


S = _load("chip_smoke")


# ------------------------------------------------------------- the plan


def test_decode_parts_come_from_the_table_width_alone():
    import inspect
    assert list(inspect.signature(pa.decode_parts).parameters) == \
        ["mb", "bs", "ring"]
    kp = pa.DECODE_PART_KEYS
    for mb, bs in ((1, 4), (7, 4), (64, 16), (66, 16), (264, 16), (5, 12)):
        cap = mb * bs
        for ring in (False, True):
            n = pa.decode_parts(mb, bs, ring)
            assert n * kp >= cap                  # the parts cover the table
            # every range a row can see: paged inside [0, cap), a ring at
            # most cap consecutive positions anywhere
            starts = range(0, cap) if not ring else range(0, 3 * kp + cap)
            for lo in starts:
                hi_max = cap - 1 if not ring else lo + cap - 1
                for hi in {lo, min(hi_max, lo + kp), hi_max}:
                    assert hi // kp - lo // kp + 1 <= n, (mb, bs, ring, lo)
    assert pa.decode_parts(64, 16, False) == 4             # bnn-lm-100m
    assert pa.decode_parts(264, 16, True) == 18            # mixtral's ring


def test_decode_constants_match_the_cuda_source():
    src = (_lib.CSRC / "paged_attention.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["PART_KEYS"]) == pa.DECODE_PART_KEYS
    assert int(const["DR"]) == pa.DECODE_ROWS
    assert int(const["QT"]) == pa.GQA_TILED_ROWS
    assert "Dh == 64 || Dh == 128" in src and pa.GQA_TILED_WIDTHS == (64, 128)
    assert not pa.gqa_tiled(1, 4, 128) and not pa.gqa_tiled(4, 4, 128)
    assert pa.gqa_tiled(5, 4, 128) and not pa.gqa_tiled(17, 4, 32)


# ------------------------------------------------- the walk, in PyTorch


def split_walk(q, k_pool, v_pool, table, *, kv_len, q_offset, causal,
               window, ring, newest):
    """The decode walk's algorithm: per (batch row, kv head, tile of
    DECODE_ROWS query rows) the visible positions [lo, hi], their parts
    of DECODE_PART_KEYS positions, each part's (m, l, acc), merged in
    part order.  Asserts that no row tile needs more parts than the
    grid gives it."""
    b, c, h, dh = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    mb = table.shape[1]
    cap, g, kp, dr = mb * bs, h // hkv, pa.DECODE_PART_KEYS, pa.DECODE_ROWS
    nsplit = pa.decode_parts(mb, bs, ring)
    out = torch.zeros_like(q)
    scale = dh ** -0.5
    for bi in range(b):
        qoff, length = int(q_offset[bi]), int(kv_len[bi])
        for kh in range(hkv):
            for r0 in range(0, c * g, dr):
                nr = min(dr, c * g - r0)
                qlo, qhi = qoff + r0 // g, qoff + (r0 + nr - 1) // g
                lo = max(0, qlo - window + 1) if window else 0
                hi = min(length - 1, qhi) if causal else length - 1
                if ring:
                    hi = min(hi, int(newest[bi]))
                    lo = max(lo, int(newest[bi]) - cap + 1)
                else:
                    hi = min(hi, cap - 1)
                kf = lo // kp
                nlive = hi // kp - kf + 1 if hi >= lo else 1
                assert nlive <= nsplit
                for r in range(nr):
                    row = r0 + r
                    qv = q[bi, row // g, kh * g + row % g] * scale
                    qpos = qoff + row // g
                    parts = []
                    for z in range(nlive):
                        ps = max(lo, (kf + z) * kp)
                        pe = min(hi, (kf + z + 1) * kp - 1)
                        pos = torch.arange(ps, pe + 1)
                        slot = pos % cap if ring else pos
                        phys = table[bi, slot // bs].long()
                        keys = k_pool[phys, slot % bs, kh]
                        vals = v_pool[phys, slot % bs, kh]
                        ok = torch.ones(len(pos), dtype=torch.bool)
                        if causal:
                            ok &= pos <= qpos
                        if window:
                            ok &= qpos - pos < window
                        s = keys @ qv
                        m = s[ok].max() if ok.any() else torch.tensor(-1e30)
                        p = torch.where(ok, torch.exp(s - m), 0.0)
                        parts.append((m, p.sum(), p @ vals))
                    m = max(pm for pm, _, _ in parts)
                    l = sum(pl * torch.exp(pm - m) for pm, pl, _ in parts)
                    acc = sum(pa_ * torch.exp(pm - m) for pm, _, pa_ in parts)
                    out[bi, row // g, kh * g + row % g] = \
                        acc / torch.clamp(l, min=1e-20)
    return out


# (C, H, Hkv, Dh, BS, MB, window, ring, kv_len / newest per row)
WALK_CASES = [
    (1, 4, 1, 16, 4, 130, None, False, (255, 256, 257, 0, 1, 3, 520)),
    (1, 4, 2, 8, 4, 130, 300, False, (299, 300, 301, 519, 520, 257)),
    (4, 8, 2, 8, 4, 80, None, False, (256, 257, 259, 320, 4)),
    (1, 4, 1, 16, 4, 70, None, True, (279, 280, 281, 559, 560, 700, 0, 5)),
    (1, 4, 1, 16, 4, 70, 100, True, (279, 280, 560, 700, 511, 512, 2)),
    (4, 4, 1, 16, 4, 70, 37, True, (300, 559, 560, 1001)),
]


@pytest.mark.parametrize("case", WALK_CASES)
def test_split_walk_matches_the_plain_version(case):
    c, h, hkv, dh, bs, mb, window, ring, rows = case
    rng = np.random.default_rng(len(rows) * 100 + mb)
    b = len(rows)
    nb = b * mb + 1
    table = torch.from_numpy(
        (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((b, c, h, dh)).astype(np.float32))
    kpool = torch.from_numpy(
        rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32))
    vpool = torch.from_numpy(
        rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32))
    rows = torch.tensor(rows, dtype=torch.int32)
    if ring:                         # kv_len = newest + 1, as the engine
        newest, kv_len = rows, rows + 1
    else:
        newest, kv_len = None, rows
    q_off = (kv_len - c).clamp_min(0) if c > 1 else kv_len - 1
    kw = dict(kv_len=kv_len, q_offset=q_off.to(torch.int32), causal=c > 1,
              window=window, ring=ring, newest=newest)
    want = pa.paged_attention_torch(q, kpool, vpool, table, **kw)
    got = split_walk(q, kpool, vpool, table, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    blind = kv_len == 0
    assert (got[blind] == 0).all() and (want[blind] == 0).all()


# ------------------------------------------------------ the decode replay

# reduced configs of the four served families on the CPU engine; the
# block pools are small enough that the scheduler preempts, mixtral's
# 10-block ring (40 slots) wraps under its longer requests, and mamba2's
# 2 recurrent slots serve 5 requests in turn
FAMILIES = {
    "bnn-lm-100m": (dict(block_size=4, num_blocks=14, max_batch=4,
                         prefill_chunk=8, max_model_len=64),
                    (3, 6, 9, 5, 20), (10, 8, 6, 9, 12)),
    "mixtral-8x7b": (dict(block_size=4, num_blocks=22, max_batch=4,
                          prefill_chunk=8, max_model_len=96),
                     (30, 26, 22, 40, 52), (14, 16, 18, 8, 10)),
    "deepseek-v2-lite-16b": (dict(block_size=4, num_blocks=14, max_batch=4,
                                  prefill_chunk=8, max_model_len=64),
                             (14, 10, 18, 9, 12), (10, 12, 8, 9, 7)),
    "mamba2-1.3b": (dict(max_batch=4, num_slots=3, prefill_chunk=8,
                         max_model_len=64),
                    (3, 6, 20, 5, 17), (10, 8, 6, 9, 12)),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def served(request):
    arch = request.param
    ecfg, lens, max_new = FAMILIES[arch]
    cfg = reduced(get_config(arch)).replace(precision="bnn")
    params = M.init(torch.Generator().manual_seed(0), cfg)
    eng = Engine(params, cfg, EngineConfig(**ecfg), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
    for p, n in zip(prompts[:3], max_new[:3]):
        eng.submit(p, n)
    for _ in range(4):
        eng.step()
    for p, n in zip(prompts[3:], max_new[3:]):
        eng.submit(p, n)
    out = eng.run()
    assert len(out) == len(prompts)
    return arch, cfg, params, eng, out


def test_decode_replay_reproduces_the_engine_tokens(served):
    arch, cfg, params, eng, out = served
    for rid, seq in out.items():
        tokens, flips, worst, kept = S.decode_replay(
            params, cfg, eng, rid, CPU, f"{arch} rid {rid}")
        p = eng.requests[rid].prompt_len
        np.testing.assert_array_equal(tokens, seq[p:])
        # on the CPU both routes are the plain versions
        assert flips == 0 and worst == 0.0
        assert sorted(kept) == list(range(p, len(seq) - 1))
    st = eng.stats()
    assert st["max_concurrent_decode"] >= 2
    if eng.cache.ssm is not None:         # slots handed out again
        assert st["preemptions"] == 0
        assert any(len(r) > 1 for r in S.slot_owners(eng).values())
    else:
        assert st["preemptions"] >= 1
    if eng.cache.ring_blocks:
        cap = eng.cache.ring_blocks * eng.ecfg.block_size
        assert max(len(s) for s in out.values()) > cap      # a ring wraps
        assert st["mixer"]["blocks"]["ring_reuses"] > 0


def test_engine_calls_follow_the_last_admission(served):
    _arch, _cfg, _params, eng, out = served
    evicted = {e["rid"] for e in eng.scheduler.trace if e["event"] == "evict"}
    assert evicted or eng.cache.ssm is not None
    for rid, seq in out.items():
        calls = S.engine_calls(eng, rid)
        pre = [c for c in calls if c[0] == "prefill"]
        dec = [c for c in calls if c[0] == "decode"]
        p = eng.requests[rid].prompt_len
        assert [c[1] for c in pre] == list(range(0, p, eng.ecfg.prefill_chunk))
        assert sum(c[2] for c in pre) == p
        assert len(dec) == len(seq) - p - 1
        assert all(0 <= row < bsz <= eng.ecfg.max_batch
                   for _k, row, bsz in dec)


def test_e2e_phase_holds_on_the_cpu(served):
    """Both routes and their cross-check, every finished request."""
    _arch, cfg, params, eng, out = served
    S.phase_e2e(CPU, cfg, params, eng, out, rids=sorted(out))


def test_route_gap_is_rounding_on_the_reduced_configs(served):
    """The chunked re-check against the decode replay at the generated
    positions: on the reduced configs (the SSD dual form against the
    recurrence for mamba2) the BNN inputs differ by rounding and no sign
    bit flips, so ``_cross_check`` finds no place where they part."""
    _arch, cfg, params, eng, out = served
    for rid, seq in out.items():
        p = eng.requests[rid].prompt_len
        _t, _f, _w, kept_r = S.decode_replay(params, cfg, eng, rid, CPU,
                                             f"rid {rid}")
        *_rest, kept_c = S._teacher_forced(
            params, cfg, seq, eng.ecfg.prefill_chunk, eng.ecfg.block_size,
            eng.cache.ring_blocks, CPU, f"rid {rid}", keep_from=p)
        gap, flips, far = S._route_gap(kept_r, kept_c)
        assert gap < 1e-5 and flips == far == 0, (rid, gap, flips)
        assert S._cross_check(f"rid {rid}", kept_r, kept_c, "") is None


def test_mamba2_recheck_takes_the_longest_and_a_reused_slot(served):
    """The smoke's mamba2 pick: the longest request, and the first one
    admitted to a slot another request had released; each replayed in
    the slot the engine gave it."""
    _arch, _cfg, _params, eng, out = served
    owners = S.slot_owners(eng)
    if eng.cache.ssm is None:
        assert owners == {}
        return
    assert sorted(owners) == [1, 2]
    assert sorted(r for rids in owners.values() for r in rids) == sorted(out)
    longest, reused = S.mamba2_rids(eng, out)
    assert len(out[longest]) == max(len(s) for s in out.values())
    slot = S.engine_slot(eng, reused)
    assert owners[slot].index(reused) >= 1


# --------------------------------------------------------- the launcher


def test_launch_runs_on_the_tensors_device_and_stream(monkeypatch):
    current = {"dev": 0}
    calls = []

    def index(d):                   # a device index, or a cuda device
        return d if isinstance(d, int) else torch.device(d).index

    @contextlib.contextmanager
    def device(d):
        prev, current["dev"] = current["dev"], index(d)
        try:
            yield
        finally:
            current["dev"] = prev

    class Stream:
        def __init__(self, idx):
            self.cuda_stream = 1000 + idx

    def current_stream(device=None):
        return Stream(current["dev"] if device is None else index(device))

    class Lib:
        @staticmethod
        def fn(*args):
            calls.append((current["dev"], args[:-1], args[-1].value))
            return 0

        @staticmethod
        def bad(*args):
            return 700

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["dev"])
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_lib.LIBRARY, "handle", Lib())
    _lib.launch("fn", torch.device("cuda", 1), 7, 8)
    _lib.launch("fn", torch.device("cuda", 0), 9)      # already current
    current["dev"] = 1
    _lib.launch("fn", torch.device("cuda", 0), 6)
    _lib.launch("fn", torch.device("cuda"), 5)         # the current one
    current["dev"] = 0
    assert calls == [(1, (7, 8), 1001), (0, (9,), 1000), (0, (6,), 1000),
                     (1, (5,), 1001)]
    assert current["dev"] == 0                 # restored after the call
    with pytest.raises(RuntimeError, match="bad: CUDA error 700"):
        _lib.launch("bad", torch.device("cuda", 1))


def test_decode_counters_grow_and_keep_the_old_buffer(monkeypatch):
    monkeypatch.setattr(pa, "_counters", {})
    monkeypatch.setattr(pa, "_retired", [])
    a = pa._decode_counters(CPU, 10)
    assert a.numel() >= 10 and not a.any() and a.dtype == torch.int32
    assert pa._decode_counters(CPU, 5) is a
    b = pa._decode_counters(CPU, a.numel() + 1)
    assert b.numel() > a.numel() and not b.any()
    assert pa._retired == [a]


def test_every_port_kernel_counts_as_the_ports_own():
    prof = _load("chip_profile")
    names = prof.port_kernel_names()
    srcs = "".join(p.read_text() for p in sorted(_lib.CSRC.glob("*.cu*")))
    assert len(names) == srcs.count("__global__") >= 12
    assert {"paged_attention_decode_kernel", "paged_attention_tiled_kernel",
            "tf32x3_gemm_kernel", "mla_decode_kernel", "absorb_small_kernel",
            "v_up_small_kernel", "mla_tiled_kernel", "small_kernel",
            "tc_kernel", "tile_kernel", "binarize_pack_kernel",
            "pack_patches_kernel", "pack_rows_kernel"} <= names
    assert not {"mla_walk_kernel", "mla_merge_kernel"} & names
    frozen = frozenset(names)
    for n in names:                      # the profiler's demangled names
        assert prof.is_port_kernel(
            f"void (anonymous namespace)::{n}<4>(float const*, int)", frozen)
        assert prof.is_port_kernel(f"void ns::{n}(float const*)", frozen)
    for other in ("ampere_sgemm_128x64_nn",
                  "void at::native::vectorized_elementwise_kernel<4, "
                  "at::native::CUDAFunctor_add<float> >(int)",
                  "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>"
                  "(Params)"):
        assert not prof.is_port_kernel(other, frozen)
