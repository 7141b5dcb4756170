"""What one cell needs of each H100, without an H100: the PyTorch port's
dry-run.

Traces ``--arch`` × ``--shape`` on fake tensors over the H100 production
mesh (256 GPUs as data 32 × model 8, or 512 with ``--multi-pod`` as pod 2
× data 32 × model 8): a fake process group of the mesh's size, the
parameters and optimizer state as DTensors placed by the port's sharding
rules, the step under the activation-sharding context. Nothing is
allocated. Prints the cell's record: peak memory a device and whether it
fits 80 GB, the FLOPs, bytes and collective bytes a device, the roofline
terms on the H100's spec-sheet peaks, and the kernels' launches. With
``--data N`` the mesh is N nodes of 8 instead (data N × model 8): how
small a cluster still fits a cell. With
``--smoke`` the architecture's smoke configuration runs at (4, 64) on a
(data 2, model 2) mesh instead, in seconds.

    PYTHONPATH=src python examples/torch_dryrun.py --smoke
    PYTHONPATH=src python examples/torch_dryrun.py --arch dbrx-132b \
        --shape train_4k
    PYTHONPATH=src python examples/torch_dryrun.py --arch dbrx-132b \
        --shape train_4k --data 8
"""

import argparse
import json

from repro_torch.launch.dryrun import cell_record
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.config import SHAPES, ShapeConfig, get_config


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--data", type=int, default=0,
                    help="a mesh of data N x model 8 instead")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configuration at (4, 64) on a 2 x 2 mesh")
    args = ap.parse_args()
    if args.smoke:
        kind = SHAPES[args.shape].kind
        shape = ShapeConfig(f"smoke_{kind}", 64, 4, kind)
        rec = cell_record(args.arch, shape.name,
                          Mesh(("data", "model"), (2, 2)),
                          cfg=get_config(args.arch, smoke=True),
                          shape=shape, verbose=True)
    elif args.data:
        rec = cell_record(args.arch, args.shape,
                          Mesh(("data", "model"), (args.data, 8)),
                          verbose=True)
    else:
        rec = cell_record(args.arch, args.shape,
                          make_production_mesh(multi_pod=args.multi_pod),
                          multi_pod=args.multi_pod, verbose=True)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
