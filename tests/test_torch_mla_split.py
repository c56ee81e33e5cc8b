"""The split decode walk of the port's MLA latent attention, on the CPU.

* The walk's plan (``kernels/paged_attention.mla_decode_parts``): sized
  from the table width alone, never the batch, and its parts cover every
  range of positions a row can see; the constants the CUDA source and
  the wrapper share agree.
* The walk's algorithm, written out in plain PyTorch here in the CUDA
  kernel's absorbed order (k_up folded into the query; per tile of
  MLA_TILE_ROWS query rows the visible positions [lo, hi], cut into
  parts of MLA_PART_KEYS, an online softmax over each part's latents in
  tiles of 16 keys, the parts' states merged in part order, v_up applied
  after),
  against the plain version ``paged_attention_mla_torch`` and the JAX
  package's Pallas kernel in interpret mode, on paged tables, rings
  that wrap, windows, part boundaries and blind rows (float32,
  ATOL/RTOL: summation order, as tests/test_torch_mla.py).

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain version and each row of a batch against the
same row run alone."""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import _lib, paged_attention as pa

torch.set_num_threads(1)

ATOL = RTOL = 1e-5          # float32 attention: reduction-order rounding
TILE_KEYS = 16              # keys per latent tile of the CUDA walk


def test_mla_decode_parts_come_from_the_table_width_alone():
    assert list(inspect.signature(pa.mla_decode_parts).parameters) == \
        ["mb", "bs", "ring"]
    kp = pa.MLA_PART_KEYS
    for mb, bs in ((1, 4), (7, 4), (40, 4), (64, 16), (66, 16), (5, 12)):
        cap = mb * bs
        for ring in (False, True):
            n = pa.mla_decode_parts(mb, bs, ring)
            assert n * kp >= cap                  # the parts cover the table
            starts = range(0, cap) if not ring else range(0, 3 * kp + cap)
            for lo in starts:
                hi_max = cap - 1 if not ring else lo + cap - 1
                for hi in {lo, min(hi_max, lo + kp), hi_max}:
                    assert hi // kp - lo // kp + 1 <= n, (mb, bs, ring, lo)
    assert pa.mla_decode_parts(64, 16, False) == -(-1024 // kp)  # deepseek


def test_mla_constants_match_the_cuda_source():
    src = (_lib.CSRC / "paged_attention_mla.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["PART_KEYS"]) == pa.MLA_PART_KEYS
    assert int(const["RT"]) == pa.MLA_TILE_ROWS <= pa.MLA_ROWS
    assert int(const["DK"]) == TILE_KEYS
    assert int(const["MAX_R"]) == pa.MLA_DECODE_MAX_R
    assert pa.MLA_PART_KEYS % TILE_KEYS == 0
    assert "mla_splits" not in src and "mla_merge_kernel" not in src
    assert not hasattr(pa, "mla_splits")


def split_walk_mla(q, ckv, krope, table, *, k_up, v_up, nope_dim, kv_len,
                   q_offset, causal, window, ring, newest):
    """The decode route's algorithm (see the module docstring).  Asserts
    that no row tile needs more parts than the grid gives it."""
    b, c, h, dq = q.shape
    bs, r = ckv.shape[1], ckv.shape[2]
    mb = table.shape[1]
    dv = v_up.shape[1] // h
    cap, kp, rt = mb * bs, pa.MLA_PART_KEYS, pa.MLA_TILE_ROWS
    nsplit = pa.mla_decode_parts(mb, bs, ring)
    scale = dq ** -0.5
    q_lat = scale * torch.einsum("bchn,rhn->bchr", q[..., :nope_dim],
                                 k_up.reshape(r, h, nope_dim))
    qa = torch.cat([q_lat, scale * q[..., nope_dim:]], dim=-1)
    merged = torch.zeros((b, c * h, r))
    rows = c * h
    for bi in range(b):
        qoff, length = int(q_offset[bi]), int(kv_len[bi])
        for r0 in range(0, rows, rt):
            nr = min(rt, rows - r0)
            qlo, qhi = qoff + r0 // h, qoff + (r0 + nr - 1) // h
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
            for row in range(r0, r0 + nr):
                qv = qa[bi, row // h, row % h]
                qpos = qoff + row // h
                parts = []
                for z in range(nlive):
                    ps = max(lo, (kf + z) * kp)
                    pe = min(hi, (kf + z + 1) * kp - 1)
                    m, l, acc = torch.tensor(-1e30), torch.tensor(0.0), \
                        torch.zeros(r)
                    # tiles of TILE_KEYS positions aligned to TILE_KEYS
                    for t0 in range(ps // TILE_KEYS * TILE_KEYS, pe + 1,
                                    TILE_KEYS):
                        pos = torch.arange(t0, t0 + TILE_KEYS)
                        ok = (pos >= ps) & (pos <= pe)
                        if causal:
                            ok &= pos <= qpos
                        if window:
                            ok &= qpos - pos < window
                        slot = (pos % cap if ring else pos.clamp(0, cap - 1))
                        phys = table[bi, slot // bs].long()
                        keys = torch.cat([ckv[phys, slot % bs],
                                          krope[phys, slot % bs]], dim=-1)
                        s = keys @ qv
                        m_new = torch.maximum(
                            m, s[ok].max() if ok.any() else torch.tensor(-1e30))
                        a = torch.exp(m - m_new)
                        p = torch.where(ok, torch.exp(s - m_new), 0.0)
                        l = l * a + p.sum()
                        acc = acc * a + p @ ckv[phys, slot % bs]
                        m = m_new
                    parts.append((m, l, acc))
                mx = max(pm for pm, _, _ in parts)
                l = sum(pl * torch.exp(pm - mx) for pm, pl, _ in parts)
                acc = sum(pa_ * torch.exp(pm - mx) for pm, _, pa_ in parts)
                merged[bi, row] = acc / torch.clamp(l, min=1e-20)
    out = torch.einsum("bchr,rhv->bchv", merged.reshape(b, c, h, r),
                       v_up.reshape(r, h, dv))
    return out


# (C, H, BS, MB, window, ring, kv_len / newest per row), with the
# CUDA route's rows: C * H <= 16 query rows a batch row; kv_len one
# short of, at and one past part boundaries (KP), rings of CAP slots
# whose arcs start around a part boundary and wrap
KP = pa.MLA_PART_KEYS
CAP = 160
WALK_CASES = [
    (1, 4, 4, -(-(2 * KP + 40) // 4), None, False,
     (KP - 1, KP, KP + 1, 0, 1, 3, 2 * KP + 40)),
    (1, 4, 4, -(-(2 * KP + 8) // 4), 50, False,
     (KP - 1, KP, KP + 1, 2 * KP - 1, 2 * KP, 2 * KP + 1)),
    (4, 4, 4, -(-(2 * KP + 8) // 4), None, False,
     (KP, KP + 1, KP + 3, 2 * KP + 2, 4)),
    (1, 4, 4, CAP // 4, None, True,
     (KP + CAP - 2, KP + CAP - 1, KP + CAP, 2 * CAP - 1, 2 * CAP, 0, 5,
      3 * CAP + 7)),
    (1, 4, 4, CAP // 4, 30, True,
     (KP + CAP - 1, KP + CAP, 2 * CAP, 2 * CAP + 40, KP - 1, KP, 2)),
    (2, 8, 4, CAP // 4, 37, True, (100, KP + CAP - 1, KP + CAP, 301)),
]


def _case(case):
    c, h, bs, mb, window, ring, rows = case
    rng = np.random.default_rng(len(rows) * 100 + mb + c)
    b, r, dr, nope, dv = len(rows), 16, 8, 8, 8
    nb = b * mb + 1
    d = dict(
        q=rng.standard_normal((b, c, h, nope + dr)).astype(np.float32),
        ckv=rng.standard_normal((nb, bs, r)).astype(np.float32),
        krope=rng.standard_normal((nb, bs, dr)).astype(np.float32),
        table=(1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32),
        k_up=(0.2 * rng.standard_normal((r, h * nope))).astype(np.float32),
        v_up=(0.2 * rng.standard_normal((r, h * dv))).astype(np.float32))
    rows = np.asarray(rows, np.int32)
    if ring:                         # kv_len = newest + 1, as the engine
        d["newest"], d["kv_len"] = rows, rows + 1
    else:
        d["newest"], d["kv_len"] = None, rows
    q_off = np.maximum(d["kv_len"] - c, 0) if c > 1 else d["kv_len"] - 1
    d["q_off"] = q_off.astype(np.int32)
    return d, nope, dict(causal=c > 1, window=window, ring=ring)


@pytest.mark.parametrize("case", WALK_CASES)
def test_split_walk_matches_plain_and_pallas(case):
    d, nope, flags = _case(case)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}
    kw = dict(k_up=t["k_up"], v_up=t["v_up"], nope_dim=nope,
              kv_len=t["kv_len"], q_offset=t["q_off"], newest=t["newest"],
              **flags)
    want = pa.paged_attention_mla_torch(t["q"], t["ckv"], t["krope"],
                                        t["table"], **kw)
    got = split_walk_mla(t["q"], t["ckv"], t["krope"], t["table"], **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    J = jnp.asarray
    pallas = np.asarray(jpa.paged_attention(
        J(d["q"]), J(d["ckv"]), J(d["krope"]), J(d["table"]),
        kv_len=J(d["kv_len"]), q_offset=J(d["q_off"]), layout="mla",
        causal=flags["causal"], window=flags["window"], ring=flags["ring"],
        newest=None if d["newest"] is None else J(d["newest"]),
        k_up=J(d["k_up"]), v_up=J(d["v_up"]), nope_dim=nope,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=RTOL)
    blind = d["kv_len"] == 0
    assert (got[blind] == 0).all() and (want[blind] == 0).all()
