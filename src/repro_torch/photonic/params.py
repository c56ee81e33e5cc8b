"""Device and peripheral parameters — paper Tables I and III.

All latencies in seconds, powers in watts, energies in joules, areas in mm^2.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peripheral:
    power_w: float
    latency_s: float
    area_mm2: float


# Table III — accelerator peripherals
REDUCTION_NETWORK = Peripheral(0.050e-3, 3.125e-9, 3.00e-5)
ACTIVATION_UNIT = Peripheral(0.52e-3, 0.78e-9, 6.00e-5)
IO_INTERFACE = Peripheral(140.18e-3, 0.78e-9, 2.44e-2)
POOLING_UNIT = Peripheral(0.4e-3, 3.125e-9, 2.40e-4)
EDRAM = Peripheral(41.1e-3, 1.56e-9, 1.66e-1)
BUS = Peripheral(7e-3, 5 * 0.78e-9, 9.00e-3)       # 5 cycles @ 1.28 GHz clock
ROUTER = Peripheral(42e-3, 2 * 0.78e-9, 1.50e-2)   # 2 cycles

# Tuning (Table III)
EO_TUNING_POWER_W_PER_FSR = 80e-6
EO_TUNING_LATENCY_S = 20e-9
TO_TUNING_POWER_W_PER_FSR = 275e-3
TO_TUNING_LATENCY_S = 4e-6

# OXG device figures (paper Sec. III-B)
OXG_ENERGY_J = 0.032e-9
OXG_AREA_MM2 = 0.011

# PCA electronics (paper Sec. III-B2 + [20]): photodetector + TIR pair +
# comparator.  TIR receiver power follows Sludds et al. [20] class receivers.
PCA_POWER_W = 2.0e-3
PCA_AREA_MM2 = 0.0005

# ADC power for prior-work bitcount paths (ROBIN electronic ADC @ ~1 GS/s,
# LIGHTBULB optical ADC): B_ONN class simulators use ~2 mW/GS/s ADCs.
ADC_POWER_W_PER_GSPS = 2.0e-3

# DAC/driver energy per operand bit toggled into an OXG PN junction
DRIVER_ENERGY_PER_BIT_J = 0.1e-12   # 0.1 pJ/bit (typical SiPh modulator driver)

# Laser wall-plug efficiency (Table I)
WALL_PLUG_EFF = 0.1
