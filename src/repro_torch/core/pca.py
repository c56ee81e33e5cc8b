"""Photo-Charge Accumulator (PCA) behavioral model — paper Fig. 4, Sec. III-B2.

A photodetector converts each incident optical '1' into a current pulse;
the active time-integrating receiver (TIR) capacitor accrues

    dV = gain * i_pulse * dt / C        (i = Rs * P_pd,  dt = 1/DR)

so the TIR output voltage after accumulating ``n`` ones is ``n * dV`` —
the analog bitcount.  Capacity gamma = number of '1's that fit in the
5 V dynamic range; alpha = gamma / N = number of N-bit XNOR vector slices
that can be accumulated before saturation (Table II).

Calibration note: the naive dV = Rs*P*dt/C * gain underestimates the
paper's MultiSim-extracted gamma by a constant factor (their extracted
current pulses include receiver-chain gain not reported in the paper).
Table II is self-consistent with  gamma = K * P_pd / DR  at
K ~= 3.1e7 mW^-1 GS/s; we fit K once to Table II and expose both the
fitted model and the exact table values (default).  The functional
invariants the accelerator relies on (linear accrual, saturation at
gamma, ping-pong continuation while the sibling capacitor drains,
comparator activation) are modeled exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Table II of the paper: DR (GS/s) -> (P_PD-opt dBm, N, gamma, alpha)
TABLE_II = {
    3:  (-24.69, 66, 39682, 601),
    5:  (-23.49, 53, 29761, 561),
    10: (-21.90, 39, 19841, 508),
    20: (-20.50, 29, 14880, 513),
    30: (-19.50, 24, 10822, 450),
    40: (-18.90, 21, 9920, 472),
    50: (-18.50, 19, 8503, 447),
}

# K fitted to Table II:  gamma = K * P_pd(mW) / DR(GS/s)
_K_FIT = float(np.mean([
    g * dr / (10 ** (p / 10.0)) for dr, (p, n, g, a) in TABLE_II.items()
]))


@dataclass(frozen=True)
class PCAParams:
    v_range: float = 5.0      # TIR dynamic range (V), V_REF = v_range/2
    c_farad: float = 10e-12   # C1 = C2 = 10 pF
    tir_gain: float = 50.0
    responsivity: float = 1.2  # A/W
    gamma: int = 8503          # accumulation capacity (# of '1's)

    @property
    def dv(self) -> float:
        """Voltage accrued per accumulated '1' (V)."""
        return self.v_range / self.gamma


def gamma_from_model(datarate_gsps: float, p_pd_dbm: float) -> int:
    """Fitted physical model gamma = K * P_pd / DR (see module docstring)."""
    return int(round(_K_FIT * (10 ** (p_pd_dbm / 10.0)) / datarate_gsps))


def pca_for_datarate(datarate_gsps: int, use_table: bool = True) -> PCAParams:
    if use_table and datarate_gsps in TABLE_II:
        return PCAParams(gamma=TABLE_II[datarate_gsps][2])
    from repro_torch.core import scalability  # local import to avoid cycle
    p_pd = scalability.pd_sensitivity_dbm(datarate_gsps)
    return PCAParams(gamma=gamma_from_model(datarate_gsps, p_pd))


def alpha_capacity(p: PCAParams, n: int) -> int:
    """alpha = gamma / N: XNOR vector slices accumulable before saturation."""
    return p.gamma // n


# The charge model works on float32 tensors, as the JAX package's does on
# float32 arrays; voltages and counts may also be numpy or Python numbers
# (the mapping executor's scalars).

def _volts(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def accumulate(v0, ones_count, p: PCAParams = PCAParams()) -> torch.Tensor:
    """One PASS: accrue ``ones_count`` '1's worth of charge onto voltage v0.

    Clips at the dynamic range (saturation).  Linear below saturation:
    v = v0 + ones * dv.
    """
    v = _volts(v0) + torch.as_tensor(ones_count).to(torch.float32) * p.dv
    return torch.clamp(v, max=p.v_range)


def saturated(v, p: PCAParams = PCAParams()) -> torch.Tensor:
    return _volts(v) >= p.v_range - 0.5 * p.dv


def readout_bitcount(v, p: PCAParams = PCAParams()) -> torch.Tensor:
    """Invert the charge->voltage map: bitcount = round(v / dv)."""
    return torch.round(_volts(v) / p.dv).to(torch.int32)


def comparator(v, z_max, p: PCAParams = PCAParams()) -> torch.Tensor:
    """Fig. 4 comparator: activation = (z > 0.5*z_max) via V_REF compare.

    V_REF corresponds to half the *full vector* count: 0.5 * z_max * dv.
    """
    v_ref = 0.5 * torch.as_tensor(z_max, dtype=torch.float32) * p.dv
    return (_volts(v) > v_ref).to(torch.uint8)


@dataclass
class PingPongPCA:
    """Stateful two-capacitor PCA (C1/C2 with demux/mux, Fig. 4).

    While the just-read capacitor discharges (``discharge_passes`` PASS
    slots), the sibling continues accumulation — so back-to-back
    accumulation phases never stall (paper Sec. III-B2).  Used by the
    transaction-level simulator; numerical behavior is pure-functional
    ``accumulate`` on the active lane.
    """
    params: PCAParams
    discharge_passes: int = 1

    def __post_init__(self):
        self.v = np.zeros(2, np.float64)   # capacitor voltages
        self.cooldown = np.zeros(2, np.int64)
        self.active = 0

    def step(self, ones_count: int) -> float:
        """Accumulate one PASS worth of '1's; returns active voltage."""
        self.cooldown = np.maximum(self.cooldown - 1, 0)
        self.v[self.active] = min(
            self.v[self.active] + ones_count * self.params.dv, self.params.v_range
        )
        return float(self.v[self.active])

    def read_and_swap(self) -> float:
        """End of accumulation phase: read active, start its discharge,
        swap to the sibling. Returns the read voltage."""
        out = float(self.v[self.active])
        self.v[self.active] = 0.0
        self.cooldown[self.active] = self.discharge_passes
        self.active ^= 1
        if self.cooldown[self.active] > 0:
            raise RuntimeError(
                "PCA ping-pong violated: sibling capacitor still discharging"
            )
        return out
