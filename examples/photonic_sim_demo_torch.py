"""Photonic accelerator comparison (paper Fig. 7), through the PyTorch
port: simulate OXBNN_5, OXBNN_50, ROBIN_EO/PO and LIGHTBULB on the four
evaluated BNNs and print FPS / FPS/W with per-layer bottleneck
attribution for one network (the same numbers as the JAX demo), then
run VGG-small's conv2 layer, one of the simulated layers, through the
port's binarized conv on the device and hold it to the sign-conv
reference.

The simulator is host arithmetic; the conv runs on the card (the patch
pack and XNOR kernels launch there), or with ``--device cpu`` through
their plain PyTorch versions on the CPU.

Run:  PYTHONPATH=src python examples/photonic_sim_demo_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import conv
from repro_torch.photonic import accelerators as acc
from repro_torch.photonic import simulator as sim
from repro_torch.photonic import workloads as wl
from repro_torch.serving.engine import _resolve_device


def conv_check(dev, layer: str = "conv2", network: str = "vgg_small"):
    """(the layer, its output count, whether the binarized conv on
    ``dev`` equals the sign-conv reference) at batch 1, seeded."""
    spec = next(l for l in getattr(wl, network)() if l.name == layer)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, spec.h_in, spec.w_in, spec.c_in), generator=gen)
    w = torch.randn((spec.k, spec.k, spec.c_in, spec.c_out), generator=gen)
    x, w = x.to(dev), w.to(dev)
    got = conv.bnn_conv2d(x, w, stride=spec.stride, padding="SAME")
    want = conv.reference_sign_conv2d(x, w, stride=spec.stride,
                                      padding="SAME")
    return spec, got.numel(), bool(torch.equal(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    dev = _resolve_device(ap.parse_args(argv).device, "photonic demo")

    nets = list(wl.WORKLOADS)
    table = sim.compare(acc.ALL, nets)
    print(f"{'accelerator':<11s}" + "".join(f"{n:>16s}" for n in nets) +
          f"{'gmean FPS':>12s}{'gmean FPS/W':>12s}")
    for name, res in table.items():
        fps = [res[n].fps for n in nets]
        fpw = [res[n].fps_per_w for n in nets]
        print(f"{name:<11s}" + "".join(f"{f:16.1f}" for f in fps) +
              f"{sim.gmean(fps):12.1f}{sim.gmean(fpw):12.1f}")

    print("\nPer-layer bottlenecks, LIGHTBULB on VGG-small (first 8 layers):")
    r = sim.simulate(acc.LIGHTBULB, "vgg_small")
    for lr in r.layers[:8]:
        stages = " ".join(f"{s.name}={s.time_s * 1e6:.2f}us" for s in lr.stages)
        print(f"  {lr.layer:<8s} bottleneck={lr.bottleneck:<16s} {stages}")
    r2 = sim.simulate(acc.OXBNN_50, "vgg_small")
    print("\nSame layers on OXBNN_50 (no psum stage at all):")
    for lr in r2.layers[:8]:
        stages = " ".join(f"{s.name}={s.time_s * 1e6:.2f}us" for s in lr.stages)
        print(f"  {lr.layer:<8s} bottleneck={lr.bottleneck:<16s} {stages}")

    spec, n_out, same = conv_check(dev)
    print(f"\nVGG-small {spec.name} on {dev.type}: {n_out} outputs, the "
          f"binarized conv == the sign-conv reference: {same}")
    assert same


if __name__ == "__main__":
    main()
