"""The fusion engine of the PyTorch port in one tour: one description,
two execution modes.

A homogeneous ensemble of 256 members (same kernel, different arguments)
runs twice on the same ``TorchRTS`` device pool:

* ``fuse=False`` — the classic toolkit path: one task per member, one
  Python thread per task, one kernel call per task;
* ``fuse=True`` (the default) — members tagged with a fusion group key at
  compile time are packed into micro-batches and executed as a handful of
  ``torch.func.vmap`` dispatches on the device, while completions,
  failures and journal records stay per-member.

The values are verified identical member-by-member; only the wall clock
changes.

    PYTHONPATH=src python examples/torch_fused_ensemble.py
    PYTHONPATH=src python examples/torch_fused_ensemble.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.device import device_name
from repro_torch.fusion import fusable
from repro_torch.fusion.handles import to_host
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

MEMBERS = 256


@fusable(static_argnames=("steps", "device"))
def trajectory_energy(x0: float, drag: float, steps: int = 64,
                      device: str = "cuda"):
    """One ensemble member: a toy damped-oscillator rollout."""
    x = torch.as_tensor(x0, dtype=torch.float32, device=device)
    drag = torch.as_tensor(drag, dtype=torch.float32, device=device)
    v = torch.ones_like(x)
    for _ in range(steps):
        v = v - 0.05 * x - drag * v
        x = x + 0.05 * v
    return x * x + v * v


def run(fuse: bool, device: str):
    ens = api.ensemble(
        trajectory_energy,
        over=[{"x0": i / 256.0, "drag": 0.02 + (i % 4) * 0.01,
               "steps": 64, "device": device} for i in range(MEMBERS)],
        name="traj", fuse=fuse)
    holder = {}

    def factory():
        holder["rts"] = TorchRTS(device=device, slot_oversubscribe=4)
        return holder["rts"]

    t0 = time.time()
    result = api.run(ens, resources=ResourceDescription(slots=4),
                     rts_factory=factory, timeout=300)
    elapsed = time.time() - t0
    assert result.all_done, "ensemble did not complete"
    values = [float(np.asarray(to_host(s.out.result()))) for s in ens.specs]
    stats = holder["rts"].fusion_stats
    result.close()
    return elapsed, values, stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = device_name(args.device)
    t_scalar, v_scalar, _ = run(fuse=False, device=device)
    t_fused, v_fused, stats = run(fuse=True, device=device)
    print(f"device {device}")
    print(f"scalar : {MEMBERS} members in {t_scalar:.2f}s "
          f"({MEMBERS / t_scalar:.0f} tasks/s)")
    print(f"fused  : {MEMBERS} members in {t_fused:.2f}s "
          f"({MEMBERS / t_fused:.0f} tasks/s) — "
          f"{stats['dispatches']} device dispatches")
    print(f"speedup: {t_scalar / t_fused:.1f}x")
    drift = max(abs(a - b) for a, b in zip(v_scalar, v_fused))
    print(f"max member drift: {drift:.2e}")
    if drift > 1e-5:
        raise SystemExit("fused values drifted from scalar values")
    print("fused and scalar runs produced identical member values")


if __name__ == "__main__":
    main()
