"""Multi-tenant serving on the PyTorch port: socket tenants, one daemon,
shared carriers over the CUDA ``anen_distance`` kernel.

Starts a :class:`~repro_torch.serve.service.EnsembleService` on ``--device``
with its socket front-end, then drives it from several concurrent tenants.
Each submits a sweep of ``reg://analog_values`` (the AnEn member kernel of
``repro_torch.apps.anen``) over its own grid points of ONE dataset. The
fusion group key excludes the workflow namespace, so the service's
continuous-batching window packs every tenant's members into shared
carriers; each carrier's hand-batched entry launches ``anen_distance``
once, at the width of the whole carrier (on the CPU its plain version runs
and nothing is launched). Every result routes back to its own tenant and
is checked against ``compute_analogs`` at that member's locations.

    PYTHONPATH=src python examples/torch_serve_batch.py
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""

import argparse
import threading

import numpy as np
import torch

from repro_torch.apps.anen import workflow as wf
from repro_torch.apps.anen.anen import compute_analogs
from repro_torch.device import device_name
from repro_torch.kernels.anen_distance import anen_distance
from repro_torch.rts.base import ResourceDescription
from repro_torch.serve import EnsembleService, ServiceDaemon, SocketClient


# two tenants, each sweeping its own grid points of one small AnEn dataset
# (the size of the port's AnEn tests)
TENANTS = 2
LOCS = 16           # grid points per member
NY = NX = 20
N_HIST = 30


def tenant_sweep(tenant: int, members: int) -> list:
    """``members`` slices of ``LOCS`` distinct grid points, seeded by the
    tenant so the tenants differ."""
    rng = np.random.default_rng(1000 + tenant)
    return [np.stack(np.divmod(rng.choice(NY * NX, LOCS, replace=False), NX),
                     axis=1).tolist() for _ in range(members)]


def run_tenant(port: int, tenant: str, sweep: list, statics: dict,
               out: dict) -> None:
    with SocketClient("127.0.0.1", port) as client:
        handle = client.submit(
            "reg://analog_values",
            [dict(statics, locations=locs) for locs in sweep],
            tenant=tenant, name="av")
        client.wait(handle, timeout=600)
        out[tenant] = client.result(handle)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--members", type=int, default=8,
                    help="sweep width per tenant")
    ap.add_argument("--hold-ms", type=float, default=250.0,
                    help="continuous-batching window")
    args = ap.parse_args()

    # every tenant sends the same statics, device name included: the fusion
    # key holds them, and "cuda" and "cuda:0" would never share a carrier
    statics = dict(seed=0, ny=NY, nx=NX, n_hist=N_HIST, k=12,
                   device=device_name(args.device))
    service = EnsembleService(resources=ResourceDescription(slots=4),
                              serve_hold_s=args.hold_ms / 1000.0,
                              device=args.device).start()
    daemon = ServiceDaemon(service, port=0).start()
    print(f"daemon listening on 127.0.0.1:{daemon.port}, device "
          f"{statics['device']}")

    sweeps = {f"t{t}": tenant_sweep(t, args.members)
              for t in range(TENANTS)}
    results: dict = {}
    launches0 = anen_distance.launches
    threads = [threading.Thread(target=run_tenant,
                                args=(daemon.port, t, sweep, statics,
                                      results))
               for t, sweep in sweeps.items()]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = service.stats()
        fusion = stats["fusion"]
        print(f"\ncarriers shared across tenants: "
              f"{fusion['cross_tenant_carriers']} (of {fusion['dispatches']}"
              f" dispatches); anen_distance launches: "
              f"{anen_distance.launches - launches0}")
        data = wf._dataset(0, NY, NX, N_HIST, statics["device"])
        worst = 0.0
        for tenant, sweep in sweeps.items():
            ts = stats["tenants"][tenant]
            print(f"  {tenant}: members={ts['members']} "
                  f"shared_dispatches={ts['shared_dispatches']} "
                  f"completions={ts['completions']}")
            assert len(results[tenant]) == len(sweep), tenant
            for i, locs in enumerate(sweep):
                ref = compute_analogs(data, torch.as_tensor(
                    locs, device=data.hist_obs.device), 12).cpu().numpy()
                got = np.asarray(results[tenant][f"av-{i}"], np.float32)
                worst = max(worst, float(np.abs(got - ref).max()))
        print(f"max |served - compute_analogs| over every member: {worst}")
        assert worst <= 1e-6, worst
        assert fusion["cross_tenant_carriers"] >= 1, \
            "expected at least one carrier mixing tenants"
        print("\nevery tenant served from shared carriers, results isolated")
    finally:
        daemon.stop()
        service.stop()


if __name__ == "__main__":
    main()
