"""Transaction-level simulator for photonic BNN accelerators (paper Sec. V).

Re-implementation of the paper's in-house simulator (B_ONN_SIM) from the
text: inference of a binarized CNN, batch 1, layers processed in
sequence; within a layer, transactions flow through pipelined stages and
the layer latency is the slowest stage plus pipeline fills.

Stages per layer (all pipelined against each other):

  IO       input+weight bit transfer (IO interface + bus, per tile)
  TUNE     weight-slice (re)programming of MRR weight banks —
           prior works only, weight-stationary amortized (Table III EO)
  PASS     the optical XNOR wave pipeline at DR symbols/s
             OXBNN: Fig. 5(b) temporal mapping, V*ceil(S/N) passes over
                    P XPEs; PCA accumulates in place (alpha checked)
             prior: Fig. 5(a) spatial mapping with fragmentation when
                    ceil(S/N) does not pack into the XPE pool, and the
                    psum-buffer write port throttles the pass interval
  PSUM     prior works only: psum buffer traffic + reduction tree
           (per-XPC, pipelined II = reduce_ii per output)
  ACT      comparator/activation (+ pooling folded in), per XPC
  DRAIN    pipeline-fill/drain latencies added once per layer

Calibration knobs that the paper does not publish (psum write width,
reduction units) are explicit AcceleratorConfig/SimKnobs fields.

A numpy copy of the JAX package's simulator: the same arithmetic, so
its numbers equal the JAX package's exactly (tests/test_torch_photonic.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.photonic import params as P
from repro_torch.photonic.accelerators import AcceleratorConfig
from repro_torch.photonic.workloads import LayerSpec, WORKLOADS


@dataclass(frozen=True)
class SimKnobs:
    psum_write_width: int = 8        # psums buffered per write transaction
    reduce_units_per_xpe: float = 1.0   # pipelined adders per XPE (tiny, Table III)
    act_units_per_xpe: float = 0.25
    io_words_per_cycle_per_tile: int = 4


@dataclass
class StageRecord:
    name: str
    time_s: float
    energy_j: float
    transactions: int


@dataclass
class LayerResult:
    layer: str
    latency_s: float
    energy_j: float
    bottleneck: str
    stages: list[StageRecord] = field(default_factory=list)


@dataclass
class SimResult:
    accelerator: str
    network: str
    latency_s: float
    energy_j: float
    layers: list[LayerResult] = field(default_factory=list)

    @property
    def fps(self) -> float:
        return 1.0 / self.latency_s

    @property
    def power_w(self) -> float:
        return self.energy_j / self.latency_s

    @property
    def fps_per_w(self) -> float:
        return self.fps / self.power_w


def _pass_schedule(acc: AcceleratorConfig, layer: LayerSpec,
                   knobs: SimKnobs) -> tuple[float, int, str]:
    """Return (pass stage time, #passes, note) for one layer."""
    n_slices = math.ceil(layer.s / acc.n)
    p = acc.total_xpes
    tau = acc.tau_s
    if acc.bitcount == "pca":
        # Fig. 5(b): all slices of one output serial on one XPE.
        if n_slices > max(acc.alpha, 1):
            # PCA would saturate: drain & continue (never hit per Sec. IV-C,
            # but handled for generality)
            extra = math.ceil(n_slices / max(acc.alpha, 1)) - 1
            n_slices_eff = n_slices + extra
        else:
            n_slices_eff = n_slices
        waves = math.ceil(layer.v / p) * n_slices_eff
        return waves * tau, layer.v * n_slices_eff, "temporal(PCA)"
    # Fig. 5(a): slices of one output spread across XPEs within a pass.
    if n_slices <= p:
        outputs_per_pass = max(p // n_slices, 1)
        passes = math.ceil(layer.v / outputs_per_pass)
    else:
        passes = layer.v * math.ceil(n_slices / p)
    # psum write port throttles the pass interval
    psum_interval = P.EDRAM.latency_s / knobs.psum_write_width
    interval = max(tau, psum_interval)
    return passes * interval, layer.v * n_slices, "spatial(psum)"


def simulate_layer(acc: AcceleratorConfig, layer: LayerSpec,
                   knobs: SimKnobs = SimKnobs()) -> LayerResult:
    n_slices = math.ceil(layer.s / acc.n)
    stages: list[StageRecord] = []

    # --- IO stage ---------------------------------------------------------
    words = math.ceil((layer.input_bits + layer.weight_bits) / 32)
    io_rate = knobs.io_words_per_cycle_per_tile * acc.num_tiles
    t_io = math.ceil(words / io_rate) * P.IO_INTERFACE.latency_s
    e_io = (P.IO_INTERFACE.power_w + acc.num_tiles * (P.BUS.power_w + P.ROUTER.power_w)
            + acc.num_tiles * P.EDRAM.power_w) * t_io
    stages.append(StageRecord("io", t_io, e_io, words))

    # --- TUNE stage (prior works) ----------------------------------------
    if acc.weight_tune_latency_s > 0:
        programs = layer.c_out * n_slices  # weight-stationary: once per slice
        waves = math.ceil(programs / acc.total_xpes)
        t_tune = waves * acc.weight_tune_latency_s
        e_tune = programs * acc.n * acc.mrrs_per_xnor * \
            acc.weight_tune_power_w * acc.weight_tune_latency_s
        stages.append(StageRecord("tune", t_tune, e_tune, programs))
    else:
        t_tune = 0.0

    # --- PASS stage -------------------------------------------------------
    t_pass, passes, note = _pass_schedule(acc, layer, knobs)
    # dynamic operand drive energy + optical source energy
    drive_bits = passes * acc.n * (2 if acc.bitcount == "pca" else 1)
    e_drive = drive_bits * P.DRIVER_ENERGY_PER_BIT_J * acc.mrrs_per_xnor
    e_laser = acc.laser_power_w() * t_pass
    # MRR tuning hold power over the pass window
    n_mrrs = acc.total_xpes * acc.n * acc.mrrs_per_xnor
    e_hold = n_mrrs * P.EO_TUNING_POWER_W_PER_FSR * t_pass
    # receiver: PCA TIRs (oxbnn) or ADCs (prior)
    if acc.bitcount == "pca":
        e_rx = acc.total_xpes * P.PCA_POWER_W * t_pass
    else:
        e_rx = acc.total_xpes * P.ADC_POWER_W_PER_GSPS * acc.datarate_gsps * t_pass
    stages.append(StageRecord(f"pass[{note}]", t_pass,
                              e_drive + e_laser + e_hold + e_rx, passes))

    # --- PSUM stage (prior works) ----------------------------------------
    if acc.bitcount == "reduce":
        # buffer traffic: one write per psum (width-batched), one read per
        # reduction operand; reduction tree: II per output per XPC.
        accesses = 2 * layer.v * n_slices / knobs.psum_write_width
        t_buf = accesses * P.EDRAM.latency_s / acc.num_tiles
        red_units = max(1, int(acc.total_xpes * knobs.reduce_units_per_xpe))
        t_red = layer.v * acc.reduce_ii_s / red_units
        t_psum = max(t_buf, t_red)
        e_psum = (P.EDRAM.power_w * acc.num_tiles * t_buf
                  + P.REDUCTION_NETWORK.power_w * red_units * t_red)
        stages.append(StageRecord("psum", t_psum, e_psum,
                                  layer.v * n_slices))
    else:
        t_psum = 0.0

    # --- ACT stage --------------------------------------------------------
    act_units = max(1, int(acc.total_xpes * knobs.act_units_per_xpe))
    t_act = layer.v * P.ACTIVATION_UNIT.latency_s / act_units
    e_act = P.ACTIVATION_UNIT.power_w * act_units * t_act \
        + P.POOLING_UNIT.power_w * acc.num_tiles * t_act
    stages.append(StageRecord("act", t_act, e_act, layer.v))

    # --- pipeline fills (once per layer) -----------------------------------
    fill = acc.tau_s + P.REDUCTION_NETWORK.latency_s + \
        P.ACTIVATION_UNIT.latency_s + 2 * P.EDRAM.latency_s + \
        (acc.weight_tune_latency_s if acc.bitcount == "reduce" else 0.0)

    times = {s.name: s.time_s for s in stages}
    bottleneck = max(times, key=times.get)
    latency = max(times.values()) + fill
    energy = sum(s.energy_j for s in stages)
    return LayerResult(layer.name, latency, energy, bottleneck, stages)


def simulate(acc: AcceleratorConfig, network: str,
             knobs: SimKnobs = SimKnobs()) -> SimResult:
    layers = WORKLOADS[network]()
    res = SimResult(acc.name, network, 0.0, 0.0)
    for layer in layers:
        lr = simulate_layer(acc, layer, knobs)
        res.layers.append(lr)
        res.latency_s += lr.latency_s
        res.energy_j += lr.energy_j
    return res


def gmean(xs: list[float]) -> float:
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def compare(accs, networks=None, knobs: SimKnobs = SimKnobs()):
    """Fig. 7: FPS and FPS/W per (accelerator, network) + gmean ratios."""
    networks = networks or list(WORKLOADS)
    table = {}
    for acc in accs:
        table[acc.name] = {net: simulate(acc, net, knobs) for net in networks}
    return table
