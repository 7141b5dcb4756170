"""Serving quickstart on the PyTorch port: embed the ensemble service in
your own process.

No socket, no daemon — the :class:`~repro_torch.serve.client.InProcessClient`
speaks the same protocol straight into the service, which is the simplest
way to give one application many concurrently-running workflows with
admission control and fair share. The service runs its carriers on
``--device``.

    PYTHONPATH=src python examples/torch_serve_quickstart.py
    PYTHONPATH=src python examples/torch_serve_quickstart.py --device cpu
"""

import argparse

import torch

from repro_torch.core.pst import register_executable
from repro_torch.device import device_name
from repro_torch.fusion import fusable
from repro_torch.serve import (AdmissionController, EnsembleService,
                               InProcessClient, TenantQuota)


@fusable(static_argnames=("device",))
def square(x, device: str = "cuda"):
    v = torch.as_tensor(x, dtype=torch.float32, device=device)
    return v * v


register_executable("quickstart_square", square)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = device_name(args.device)
    admission = AdmissionController(
        default_quota=TenantQuota(max_in_flight_members=256, max_active=4))
    service = EnsembleService(admission=admission, serve_hold_s=0.1,
                              device=device).start()
    try:
        client = InProcessClient(service)
        print(client.hello())

        handles = {
            tenant: client.submit(
                "reg://quickstart_square",
                [{"x": float(base + i), "device": device} for i in range(8)],
                tenant=tenant, name="sq")
            for tenant, base in [("research", 0), ("prod", 100)]}

        for tenant, handle in handles.items():
            client.wait(handle, timeout=120)
            results = client.result(handle)
            print(f"{tenant}: sq-0={results['sq-0']} sq-7={results['sq-7']}")

        stats = client.stats()
        print(f"cross-tenant carriers: "
              f"{stats['fusion'].get('cross_tenant_carriers', 0)}")
        print(f"admission: {stats['admission']}")

        # the `metrics` verb: per-tenant telemetry (queue-wait quantiles
        # inside the serve hold window, carrier sharing, completions)
        metrics = client.metrics()
        for tenant, m in sorted(metrics["tenants"].items()):
            wait = m.get("queue_wait") or {}
            p50 = wait.get("p50")
            print(f"metrics[{tenant}]: members={m.get('members', 0)} "
                  f"shared_carriers={m.get('shared_carriers', 0)} "
                  f"completions={m.get('completions', 0)} "
                  f"queue_wait_p50="
                  f"{f'{p50 * 1e3:.1f}ms' if p50 is not None else 'n/a'}")
    finally:
        service.stop()


if __name__ == "__main__":
    main()
