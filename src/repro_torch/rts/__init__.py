"""Runtime systems (RTS) — the black-box execution layer under EnTK.

The paper isolates the RTS into a stand-alone subsystem so EnTK can compose
with diverse runtimes and recover from whole-RTS failures (§II-B.2). This
package provides the RTS interface plus four implementations:

* :class:`repro.rts.local.LocalRTS` — thread-pool pilot with device-slot
  scheduling, failure and straggler injection (integration tests, small runs).
* :class:`repro.rts.simulated.SimulatedRTS` — discrete-event virtual-clock
  runtime with per-CI platform profiles (the scalability and overhead
  benchmarks, standing in for the paper's ``sleep`` workloads on Titan/XSEDE).
* :class:`repro.rts.jax_rts.JaxRTS` — executes jitted JAX steps on local
  devices with device leasing (the production path on a pod). The multi-pod
  dry-run reuses it with ``reg://compile_cell`` tasks — compiling *is* the
  task, so no dedicated dry-run RTS is needed.
* :class:`repro.rts.federation.FederatedRTS` — N heterogeneous member pilots
  (any mix of the above) behind one RTS interface: placement-aware packing,
  member-level heartbeat, pilot failover with quarantine/re-admission.
"""

from .base import RTS, Pilot, ResourceDescription, TaskCompletion  # noqa: F401
from .federation import FederatedRTS, MemberSpec  # noqa: F401
from .local import LocalRTS  # noqa: F401
from .simulated import SimulatedRTS  # noqa: F401

__all__ = ["RTS", "Pilot", "ResourceDescription", "TaskCompletion",
           "LocalRTS", "SimulatedRTS", "FederatedRTS", "MemberSpec"]
