"""Convolution -> XPC mapping schedules (paper Sec. IV-B, Fig. 5).

Two mappings of H binarized vector pairs of size S onto an XPC with M
XPEs of size N:

* ``plan_prior_work``  (ROBIN/LIGHTBULB style, Fig. 5(a)): the
  ceil(S/N) slices of ONE vector are spread ACROSS XPEs within a PASS.
  Every PASS emits one psum per XPE which must be stored and later
  reduced by a psum reduction network -> extra latency + energy + psum
  buffer traffic.

* ``plan_oxbnn``  (Fig. 5(b)): all slices of one vector go to the SAME
  XPE on consecutive PASSes; the PCA holds charge between PASSes, so the
  psums accumulate in place (up to alpha slices, Table II).  Zero
  reduction-network operations as long as ceil(S/N) <= alpha — which
  holds for every modern CNN since S_max = 4608 < gamma (Sec. IV-C).

Both planners return an explicit PASS-by-PASS schedule that the
functional executor (``execute_plan``) can run against real bit tensors,
using the PCA behavioral model for OXBNN and integer psum+reduce for
prior work.  Both produce identical final bitcounts, and the plans count
the eliminated reduction operations (tests/test_torch_photonic.py holds
this copy against the JAX package's).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import pca as pca_mod


@dataclass(frozen=True)
class SliceRef:
    vector: int   # which of the H vectors
    sl: int       # slice index within the vector
    start: int    # element offset
    stop: int


@dataclass(frozen=True)
class PassAssignment:
    xpe: int
    sliceref: SliceRef
    accumulate: bool   # True: PCA holds charge from previous PASS (OXBNN)
    emit: bool         # True: read out a final result after this PASS


@dataclass
class Plan:
    style: str
    m: int
    n: int
    s: int
    h: int
    passes: list[list[PassAssignment]] = field(default_factory=list)
    # bookkeeping for cost model
    psum_writes: int = 0          # psums stored to the reduction buffer
    reduction_adds: int = 0       # adds performed by the psum reduction network

    @property
    def num_passes(self) -> int:
        return len(self.passes)


def slice_bounds(s: int, n: int) -> list[tuple[int, int]]:
    """Split a length-s vector into ceil(s/n) slices of width <= n."""
    return [(i, min(i + n, s)) for i in range(0, s, n)]


def plan_oxbnn(h: int, s: int, m: int, n: int, alpha: int) -> Plan:
    """Fig. 5(b): vector v -> XPE (v mod m); its slices run back-to-back
    PASSes with the PCA accumulating.  Requires ceil(s/n) <= alpha."""
    n_slices = math.ceil(s / n)
    if n_slices > alpha:
        raise ValueError(
            f"vector needs {n_slices} slices > PCA capacity alpha={alpha}; "
            "drain/rotate required (S exceeds gamma) — not needed for any "
            "modern CNN per paper Sec. IV-C"
        )
    bounds = slice_bounds(s, n)
    plan = Plan("oxbnn", m, n, s, h)
    for group_start in range(0, h, m):
        group = list(range(group_start, min(group_start + m, h)))
        for sl, (start, stop) in enumerate(bounds):
            assignments = [
                PassAssignment(
                    xpe=j,
                    sliceref=SliceRef(v, sl, start, stop),
                    accumulate=sl > 0,
                    emit=sl == n_slices - 1,
                )
                for j, v in enumerate(group)
            ]
            plan.passes.append(assignments)
    return plan


def plan_prior_work(h: int, s: int, m: int, n: int) -> Plan:
    """Fig. 5(a): slices of one vector spread across XPEs per PASS; psums
    stored then reduced externally."""
    bounds = slice_bounds(s, n)
    n_slices = len(bounds)
    plan = Plan("prior", m, n, s, h)
    work: list[SliceRef] = [
        SliceRef(v, sl, start, stop)
        for v in range(h)
        for sl, (start, stop) in enumerate(bounds)
    ]
    for i in range(0, len(work), m):
        chunk = work[i:i + m]
        assignments = [
            PassAssignment(xpe=j, sliceref=ref, accumulate=False, emit=True)
            for j, ref in enumerate(chunk)
        ]
        plan.passes.append(assignments)
    # every slice emits a psum; reducing ceil(s/n) psums takes n_slices-1 adds
    plan.psum_writes = len(work)
    plan.reduction_adds = h * (n_slices - 1)
    return plan


def execute_plan(plan: Plan, i_bits: np.ndarray, w_bits: np.ndarray,
                 pca_params: pca_mod.PCAParams | None = None) -> np.ndarray:
    """Run a schedule against {0,1} bit matrices of shape (H, S).

    OXBNN: accumulates through the PCA charge model (voltage domain) and
    reads out bitcounts with ``readout_bitcount`` — so any PCA
    nonlinearity/saturation bug would break equivalence with prior work.
    Prior work: integer psums + external reduction.
    Returns the H final bitcounts.
    """
    h, s = i_bits.shape
    assert (h, s) == (plan.h, plan.s) and w_bits.shape == i_bits.shape
    results = np.zeros(h, np.int64)
    if plan.style == "oxbnn":
        p = pca_params or pca_mod.PCAParams()
        voltages = np.zeros(plan.m, np.float64)
        for pass_assignments in plan.passes:
            for a in pass_assignments:
                r = a.sliceref
                ones = int(np.sum(
                    i_bits[r.vector, r.start:r.stop]
                    == w_bits[r.vector, r.start:r.stop]
                ))
                if not a.accumulate:
                    voltages[a.xpe] = 0.0
                voltages[a.xpe] = float(pca_mod.accumulate(
                    np.float32(voltages[a.xpe]), np.int32(ones), p))
                if a.emit:
                    results[r.vector] = int(pca_mod.readout_bitcount(
                        np.float32(voltages[a.xpe]), p))
    else:
        psums: dict[int, list[int]] = {v: [] for v in range(h)}
        for pass_assignments in plan.passes:
            for a in pass_assignments:
                r = a.sliceref
                ones = int(np.sum(
                    i_bits[r.vector, r.start:r.stop]
                    == w_bits[r.vector, r.start:r.stop]
                ))
                psums[r.vector].append(ones)
        for v, ps in psums.items():
            results[v] = int(np.sum(ps))  # the psum reduction network
    return results


def reference_bitcounts(i_bits: np.ndarray, w_bits: np.ndarray) -> np.ndarray:
    return np.sum(i_bits == w_bits, axis=1).astype(np.int64)
