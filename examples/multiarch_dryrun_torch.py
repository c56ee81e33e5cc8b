"""Place-and-inspect example, through the PyTorch port: pick any
assigned architecture x shape and print its production-mesh record
(per-device argument, output, alias and temp bytes, the step's
collective record, the analytic model's FLOPs and bytes, the roofline
terms, every leaf's partition spec): the path the 80-cell dry-run
(``python -m repro_torch.launch.dryrun --all --both-meshes``)
automates.

It runs under a fake process group of 256 (or 512) ranks and places
and steps ``meta`` tensors, so it allocates nothing; the mesh's device
type is the card's (``--device cpu``: the CPU's).

Run:  PYTHONPATH=src python examples/multiarch_dryrun_torch.py \\
          --arch qwen1.5-0.5b --shape decode_32k [--multi-pod] [--device cpu]
"""
import argparse
import json

from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import fake_world, make_production_mesh, n_devices
from repro_torch.serving.engine import _resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for a CPU mesh")
    args = ap.parse_args(argv)
    dev = _resolve_device(args.device, "multiarch dry-run")

    with fake_world(n_devices(args.multi_pod)):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=dev.type)
        res = run_cell(args.arch, args.shape, args.multi_pod, mesh=mesh)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
