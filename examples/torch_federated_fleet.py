"""Federated fleet on the PyTorch port: one workflow across heterogeneous
pilots, with failover.

A mixed fleet — a CPU pool (LocalRTS) plus a device pool (``TorchRTS`` over
``--device``) plus a spare CPU pool — serves one ensemble:

* preprocessing tasks are free to run anywhere (least-loaded spill),
* "train" tasks are pinned to the device pool with ``Task(backend="devices")``
  (hard affinity: a device-shaped task must never land on a CPU pilot),
  and each computes on the device its pilot leases it,
* mid-run, the spare pool's pilot is killed: its in-flight tasks are
  re-journaled as FAILED-with-requeue (no retry budget consumed) and finish
  on the surviving members — zero lost completions.

    PYTHONPATH=src python examples/torch_federated_fleet.py
    PYTHONPATH=src python examples/torch_federated_fleet.py --device cpu
"""

import argparse
import threading
import time

import torch

from repro_torch.core import AppManager, Pipeline, Stage, Task
from repro_torch.core.pst import register_executable
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.local import LocalRTS
from repro_torch.rts.torch_rts import TorchRTS


def train_step(shard, devices=None):
    """A stand-in step on the device ``TorchRTS`` leases it."""
    dev = devices[0] if devices else torch.device("cpu")
    w = torch.full((64, 64), float(shard), device=dev)
    loss = float((w @ w).mean())
    time.sleep(0.05)
    return {"shard": shard, "loss": loss,
            "devices": [str(d) for d in (devices or [])]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    register_executable("torch_train_step", train_step)

    # --- the fleet: three differently-shaped pilots --------------------- #
    resources = [
        ResourceDescription(slots=4, extra={"name": "cpu"}),
        ResourceDescription(slots=2, extra={"name": "devices"}),
        ResourceDescription(slots=2, extra={"name": "spare"}),
    ]
    factories = [
        LocalRTS,
        lambda: TorchRTS(device=args.device, slot_oversubscribe=2),
        LocalRTS,
    ]

    # --- the workflow: spill-anywhere prep, device-pinned training ------ #
    pipe = Pipeline("fleet")
    prep = Stage("prep")
    prep.add_tasks([Task(name=f"prep-{i}", executable="sleep://0.2")
                    for i in range(16)])
    train = Stage("train")
    train.add_tasks([Task(name=f"train-{i}",
                          executable="reg://torch_train_step",
                          args=(i,), backend="devices")
                     for i in range(4)])
    pipe.add_stages([prep, train])

    amgr = AppManager(resources=resources, rts_factory=factories,
                      heartbeat_interval=0.1)
    amgr.workflow = [pipe]

    # --- kill the spare pool mid-run: failover, not failure ------------- #
    def kill_spare():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            fed = amgr.emgr.rts if amgr.emgr is not None else None
            if (fed is not None and getattr(fed, "_started", False)
                    and fed.members[2].rts is not None):
                break
            time.sleep(0.02)
        else:
            return
        time.sleep(0.25)
        fed.members[2].rts.simulate_dead = True
        print("!! spare pool pilot killed mid-run")

    threading.Thread(target=kill_spare, daemon=True).start()

    amgr.run(timeout=120)
    fed = amgr.emgr.rts

    print(f"all tasks DONE: {amgr.all_done}")
    print(f"fleet: {[(m.name, m.granted) for m in fed.members]}")
    print(f"members lost: {fed.members_lost}, "
          f"tasks failed over: {fed.pilot_lost_requeues}, "
          f"re-admitted: {fed.members_readmitted}")
    for m in fed.members:
        print(f"  {m.name:8s} executed {m.tasks_run} task attempts")
    done = [t for t in pipe.stages[1].tasks]
    print(f"train results on devices: "
          f"{[t.result['devices'] for t in done if t.result]}")


if __name__ == "__main__":
    main()
