"""AnEn on the sharded tier of the PyTorch port.

Runs the random-placement analog search of ``repro_torch.apps.anen`` with
every round wide enough to shard (``--members`` members, at least
``shard_min_members``) over ``--places`` lanes of one device
(:func:`repro_torch.device.virtual_devices`): each round is one
``dag-shard`` carrier whose entry node launches the CUDA ``anen_distance``
kernel once a lane, on the lane's own stream (on the CPU the kernel's
plain version runs instead). The same description then runs with
``shard=False``; the values must be equal.

    PYTHONPATH=src python examples/torch_sharded_anen.py --device cpu
    PYTHONPATH=src python examples/torch_sharded_anen.py --places 4
"""

import argparse
import time

from repro_torch.apps.anen.workflow import run_random
from repro_torch.device import virtual_devices


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--places", type=int, default=4)
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--locations", type=int, default=32,
                    help="locations a member a round")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--grid", type=int, default=48)
    args = ap.parse_args()

    places = virtual_devices(args.device, args.places)
    kw = dict(device=args.device, places=places, seed=0, ny=args.grid,
              nx=args.grid, n_hist=60, per_iter=args.members * args.locations,
              n_tasks=args.members, max_iters=args.iters,
              slots=args.places, shard_min_members=args.members)
    t0 = time.perf_counter()
    sharded = run_random(**kw)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = run_random(shard=False, **kw)
    plain_wall = time.perf_counter() - t0
    stats = sharded["fusion_stats"]
    print(f"{args.members} members x {args.locations} locations a round, "
          f"{sharded['rounds']} rounds, {args.places} places of "
          f"{places[0].device}")
    print(f"  shard carriers: {stats['shard_carriers']}, sharded "
          f"dispatches: {stats['sharded_dispatches']}, DAG carriers: "
          f"{stats['dag_carriers']}, degraded: {stats['degraded']}")
    print(f"  wall s sharded {wall:.3f}, unsharded {plain_wall:.3f}")
    print(f"  errors per round: {[round(e, 4) for e in sharded['errors']]}")
    same = sharded["values"] == plain["values"]
    print(f"  values equal to the shard=False run: {same}")
    print(f"all tasks DONE: "
          f"{sharded['all_done'] and plain['all_done'] and same}")


if __name__ == "__main__":
    main()
