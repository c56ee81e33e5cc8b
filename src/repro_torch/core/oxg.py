"""Behavioral model of the Optical XNOR Gate (OXG) — paper Fig. 3.

The OXG is an add-drop microring resonator (MRR) with two PN-junction
operand terminals.  A microheater pre-tunes the operand-independent
resonance from its fabrication position eta to the programmed position
kappa; each '1' applied to an operand terminal electro-refractively
red-shifts the resonance by one operand step ``delta``.

Programming rule (derived from Fig. 3(b)):  kappa = lambda_in - delta.
  (i,w) = (0,0): resonance at kappa        = lambda_in - delta  -> OFF resonance -> T high
  (i,w) = (0,1) or (1,0): kappa + delta    = lambda_in          -> ON resonance  -> T low
  (i,w) = (1,1): kappa + 2*delta           = lambda_in + delta  -> OFF resonance -> T high

Hence the through-port transmission T(lambda_in) is the logical XNOR of
the operands.  We model the passband as a Lorentzian with the paper's
FWHM = 0.35 nm and validate the truth table + a transient bitstream test
(tests/test_torch_photonic.py), mirroring the paper's INTERCONNECT
validation.

Device figures (paper Section III-B): FWHM 0.35 nm, DR up to 50 GS/s,
energy 0.032 nJ per op, area 0.011 mm^2.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OXGParams:
    fwhm_nm: float = 0.35          # passband full width at half maximum
    delta_nm: float = 0.35         # per-operand resonance shift (one FWHM)
    extinction: float = 0.01       # residual on-resonance transmission
    max_datarate_gsps: float = 50.0
    energy_per_op_nj: float = 0.032
    area_mm2: float = 0.011
    threshold: float = 0.5         # receiver decision threshold on T


def through_transmission(detune_nm: torch.Tensor,
                         p: OXGParams = OXGParams()) -> torch.Tensor:
    """Lorentzian notch: T = 1 - (1-extinction) / (1 + (2*detune/FWHM)^2)."""
    lorentz = 1.0 / (1.0 + (2.0 * detune_nm / p.fwhm_nm) ** 2)
    return 1.0 - (1.0 - p.extinction) * lorentz


def oxg_transmission(i_bit, w_bit, p: OXGParams = OXGParams()) -> torch.Tensor:
    """Analog through-port transmission for operand bits (broadcast;
    tensors, arrays or numbers, taken as float32).

    kappa is programmed at lambda_in - delta; each '1' operand shifts the
    resonance by +delta.
    """
    i_bit = torch.as_tensor(i_bit).to(torch.float32)
    w_bit = torch.as_tensor(w_bit).to(torch.float32)
    resonance = -p.delta_nm + p.delta_nm * (i_bit + w_bit)  # relative to lambda_in
    return through_transmission(resonance, p)


def oxg_xnor(i_bit, w_bit, p: OXGParams = OXGParams()) -> torch.Tensor:
    """Binary OXG output: thresholded transmission == logical XNOR."""
    return (oxg_transmission(i_bit, w_bit, p) > p.threshold).to(torch.uint8)


def transient(i_stream, w_stream, p: OXGParams = OXGParams()) -> torch.Tensor:
    """Paper Fig. 3(c): apply two bitstreams, return the optical trace T(t)."""
    return oxg_transmission(i_stream, w_stream, p)
