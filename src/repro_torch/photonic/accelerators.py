"""Accelerator configurations — paper Sec. V-B.

Area-proportionate analysis: every accelerator's total XPE count is
scaled so its area matches OXBNN_5 with 100 XPEs (paper's own numbers):

    OXBNN_5   (DR=5,  N=53): 100  XPEs
    OXBNN_50  (DR=50, N=19): 1123 XPEs
    ROBIN_PO  (DR=5,  N=50): 183  XPEs
    ROBIN_EO  (DR=5,  N=10): 916  XPEs
    LIGHTBULB (DR=50, N=16): 1139 XPEs

Structural model per accelerator:
  * bitcount="pca": OXBNN — psums accumulate in place across PASSes
    (Fig. 5(b)); zero reduction-network transactions while
    ceil(S/N) <= alpha.
  * bitcount="reduce": ROBIN/LIGHTBULB — one psum per (slice, PASS),
    stored then reduced by a per-XPC reduction tree (Fig. 5(a));
    mapping fragments when ceil(S/N) does not pack into M XPEs.
  * mrrs_per_xnor: 1 for the OXG, 2 for prior works (Sec. I / Sec. II-C).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import scalability
from repro_torch.core.pca import TABLE_II


@dataclass(frozen=True)
class AcceleratorConfig:
    name: str
    datarate_gsps: float
    n: int                   # XPE size (wavelengths / XNOR gates per XPE)
    total_xpes: int
    bitcount: str            # "pca" | "reduce"
    mrrs_per_xnor: int
    gamma: int               # PCA capacity ('1's); only meaningful for pca
    # psum-reduction microarchitecture (prior works). The paper does not
    # publish these; they are the calibration knobs.
    reduce_ii_s: float = 3.125e-9      # reduction tree initiation interval
    psum_buffer_access_s: float = 1.56e-9
    weight_tune_latency_s: float = 0.0  # per weight-slice (re)programming
    weight_tune_power_w: float = 0.0

    @property
    def tau_s(self) -> float:
        """PASS latency: one symbol period (Sec. III-B)."""
        return 1e-9 / self.datarate_gsps

    @property
    def m_per_xpc(self) -> int:
        """XPEs per XPC (paper considers M = N, Sec. IV-A)."""
        return self.n

    @property
    def num_xpcs(self) -> int:
        return max(1, -(-self.total_xpes // self.m_per_xpc))

    @property
    def num_tiles(self) -> int:
        """Peripheral tiling (eDRAM banks, IO, pooling) scales with area,
        i.e. with the XPE count — one tile per 16 XPEs.  (Deriving tiles
        from M=N would give a 50-XPE-per-XPC design 12x fewer psum banks
        than a 10-XPE-per-XPC design of the same area, which is not how
        the papers lay out their peripherals.)"""
        return max(1, self.total_xpes // 16)

    @property
    def alpha(self) -> int:
        return self.gamma // self.n if self.gamma else 0

    def laser_power_w(self) -> float:
        """Electrical laser power: Eq. (5) budget per wavelength x N x XPCs."""
        dr = int(self.datarate_gsps)
        p_pd = (TABLE_II[dr][0] if dr in TABLE_II
                else scalability.pd_sensitivity_dbm(dr))
        p_laser_dbm = scalability.link_budget_db(self.n, self.m_per_xpc, p_pd)
        p_opt_w = 10 ** (p_laser_dbm / 10.0) * 1e-3
        from repro_torch.photonic.params import WALL_PLUG_EFF
        return p_opt_w * self.n * self.num_xpcs / WALL_PLUG_EFF


def _gamma(dr: int) -> int:
    return TABLE_II[dr][2]


OXBNN_5 = AcceleratorConfig(
    name="OXBNN_5", datarate_gsps=5, n=53, total_xpes=100,
    bitcount="pca", mrrs_per_xnor=1, gamma=_gamma(5),
)

OXBNN_50 = AcceleratorConfig(
    name="OXBNN_50", datarate_gsps=50, n=19, total_xpes=1123,
    bitcount="pca", mrrs_per_xnor=1, gamma=_gamma(50),
)

# ROBIN (broadcast-and-weight): weight MRR bank re-programmed
# electro-optically when an XPE switches weight slices (20 ns, Table III),
# amortized by weight-stationary scheduling in the simulator.
ROBIN_PO = AcceleratorConfig(
    name="ROBIN_PO", datarate_gsps=5, n=50, total_xpes=183,
    bitcount="reduce", mrrs_per_xnor=2, gamma=0,
    weight_tune_latency_s=20e-9, weight_tune_power_w=80e-6,
)

# ROBIN's energy-optimized design point trades data rate for device energy
# (low-power modulators); OXBNN's paper pairs OXBNN_5 against ROBIN at
# DR=5 GS/s for the *performance* variant.  We model EO at 1 GS/s —
# ROBIN's published EO/PO FPS gap (the 62x vs 8x columns of Fig. 7)
# implies an ~5x rate difference under area-proportionate XPE counts.
ROBIN_EO = AcceleratorConfig(
    name="ROBIN_EO", datarate_gsps=1, n=10, total_xpes=916,
    bitcount="reduce", mrrs_per_xnor=2, gamma=0,
    weight_tune_latency_s=20e-9, weight_tune_power_w=80e-6,
)

# LIGHTBULB (microdisk XNOR + optical ADC + PCM racetrack counters):
# weight bits shift into PCM racetrack; re-programming modeled with the
# same 20 ns slice-swap cost (documented calibration assumption).
LIGHTBULB = AcceleratorConfig(
    name="LIGHTBULB", datarate_gsps=50, n=16, total_xpes=1139,
    bitcount="reduce", mrrs_per_xnor=2, gamma=0,
    weight_tune_latency_s=20e-9, weight_tune_power_w=80e-6,
)

ALL = [OXBNN_5, OXBNN_50, ROBIN_EO, ROBIN_PO, LIGHTBULB]


def by_name(name: str) -> AcceleratorConfig:
    for a in ALL:
        if a.name.lower() == name.lower():
            return a
    raise KeyError(name)
