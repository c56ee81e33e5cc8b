"""Quickstart: the OXBNN pipeline end to end, through the PyTorch port.

1. Reproduce the paper's Table II (XPC scalability) from Eqs. (3)-(5).
2. Run a binarized vector-dot-product three ways and check they agree:
   OXG+PCA behavioral model == the packed XNOR-popcount kernel ==
   direct math.  The bits are the JAX quickstart's own
   (``bernoulli(split(PRNGKey(0)), 0.5)``), drawn with the port's
   Threefry, so both print the same counts.
3. Run one binarized conv layer through both Fig. 5 mappings (OXBNN's
   PCA-temporal vs prior-work psum-reduction) and count the reduction
   ops OXBNN eliminates.

The VDP runs on the card (the kernel launches there); ``--device cpu``
runs the kernel's plain PyTorch version on the CPU.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import mapping, oxg, packing, pca, scalability, xnor
from repro_torch.kernels import ops
from repro_torch.serving.engine import _resolve_device
from repro_torch.serving.sampling import random_bits, threefry2x32


def jax_bernoulli_bits(s: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The two (1, s) bit rows of the JAX quickstart:
    ``bernoulli(k, 0.5, (1, s))`` for both keys of
    ``split(PRNGKey(0))`` (a uniform float32 draw below 0.5)."""
    zero = torch.zeros((), dtype=torch.int64, device=device)
    k1, k2 = threefry2x32(zero, zero, torch.tensor([0, 0], device=device),
                          torch.tensor([0, 1], device=device))
    out = []
    for i in range(2):
        bits = random_bits(k1[i], k2[i], (1, s))
        u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
        out.append((u < 0.5).to(torch.int32))
    return out[0], out[1]


def vdp_three_ways(device, s: int = 4608):
    """(optical, kernel, direct) bitcounts of one S-bit VDP, and the PCA
    comparator's activation, on ``device``."""
    i_bits, w_bits = jax_bernoulli_bits(s, device)
    # (a) optical: OXG array -> photodetector -> PCA charge accumulation
    t = oxg.oxg_xnor(i_bits[0], w_bits[0])           # N optical bits
    p = pca.pca_for_datarate(50)
    v = pca.accumulate(torch.zeros((), device=device), torch.sum(t), p)
    z_optical = int(pca.readout_bitcount(v, p))
    # (b) the packed XNOR-popcount kernel (its plain version on the CPU)
    z_kernel = int(ops.xnor_matmul(packing.pack_bits(i_bits),
                                   packing.pack_bits(w_bits), s,
                                   mode="bitcount")[0, 0])
    # (c) direct
    z_direct = int(xnor.xnor_bitcount_01(i_bits, w_bits)[0])
    act = int(pca.comparator(v, s, p))
    return z_optical, z_kernel, z_direct, act


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    dev = _resolve_device(ap.parse_args(argv).device, "quickstart")

    print("== Table II: XPC size N and PCA capacity vs data rate ==")
    for row in scalability.table2():
        print("  ", row)

    print("\n== One VDP, three ways (S = 4608, the max CNN vector) ==")
    z_optical, z_kernel, z_direct, act = vdp_three_ways(dev)
    print(f"   bitcount: optical(PCA)={z_optical} kernel({dev.type})="
          f"{z_kernel} direct={z_direct}")
    assert z_optical == z_kernel == z_direct
    # activation: the PCA comparator == compare(z, 0.5*z_max)
    print(f"   comparator activation (z > S/2): {act}")

    print("\n== Fig. 5 mappings: H=64 outputs, S=1152, XPE N=19, M=8 ==")
    p = pca.pca_for_datarate(50)
    rng = np.random.default_rng(0)
    ib = rng.integers(0, 2, (64, 1152)).astype(np.uint8)
    wb = rng.integers(0, 2, (64, 1152)).astype(np.uint8)
    plan_ox = mapping.plan_oxbnn(64, 1152, m=8, n=19, alpha=p.gamma // 19)
    plan_pr = mapping.plan_prior_work(64, 1152, m=8, n=19)
    r_ox = mapping.execute_plan(plan_ox, ib, wb, p)
    r_pr = mapping.execute_plan(plan_pr, ib, wb)
    assert (r_ox == r_pr).all()
    print(f"   OXBNN:  passes={plan_ox.num_passes} psum_writes="
          f"{plan_ox.psum_writes} reduction_adds={plan_ox.reduction_adds}")
    print(f"   prior:  passes={plan_pr.num_passes} psum_writes="
          f"{plan_pr.psum_writes} reduction_adds={plan_pr.reduction_adds}")
    print("   -> identical results; OXBNN eliminates the psum reduction "
          "network entirely (paper Sec. IV-C).")


if __name__ == "__main__":
    main()
