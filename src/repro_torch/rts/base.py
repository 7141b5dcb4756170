"""RTS interface: the contract EnTK assumes of its black-box runtime.

The AppManager/ExecManager treat the RTS as opaque (paper §II-B.2): it is
started with a resource description, accepts task submissions, reports
completions through a callback, answers liveness probes, and can be torn down
and replaced at any time. Everything an RTS learns or loses on failure is
re-derivable from EnTK's side (submitted-task registry + journal), which is
what makes whole-RTS restart safe.
"""

from __future__ import annotations

import dataclasses
import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional

from ..core.pst import Task


@dataclasses.dataclass
class ResourceDescription:
    """What to acquire — the paper's pilot description.

    ``slots`` generalizes cores: one slot is the unit a task's ``slots``
    requirement counts against (a CPU worker locally, a device on a pod).
    ``walltime`` and ``platform`` feed the SimulatedRTS queue model.
    """

    slots: int = 1
    walltime: float = float("inf")
    platform: str = "local"
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Pilot:
    """An acquired resource placeholder."""

    uid: str
    description: ResourceDescription
    started_at: float = 0.0
    active: bool = True


@dataclasses.dataclass
class TaskCompletion:
    """Completion event delivered by the RTS callback.

    ``pilot_lost`` marks a *synthetic* completion fabricated because the
    pilot executing the task died (federation member failover): the task
    itself did not fail, so the WFProcessor re-journals it as FAILED with an
    unconditional requeue that does not consume the task's retry budget.

    ``plan`` is the fused carrier's execution plan (mesh shape or
    micro-batch lane count, a small JSON-able dict) when the task ran as a
    member of one — journaled on the DONE record for postmortem perf
    debugging; None for scalar execution.
    """

    uid: str
    exit_code: int
    result: Any = None
    exception: Optional[str] = None
    started_at: float = 0.0
    completed_at: float = 0.0
    staging_seconds: float = 0.0
    execution_seconds: float = 0.0
    pilot_lost: bool = False
    plan: Optional[Dict[str, Any]] = None


CompletionCallback = Callable[[TaskCompletion], None]


class RequeueTask(Exception):
    """Raised by an RTS-internal execution hook to return the task to the
    runtime's queue instead of completing it (no completion is delivered,
    the task's slots are released, and it is retried when capacity frees).

    Used e.g. by the JaxRTS when a device lease would come up short: with
    slot-aware submission the Emgr never over-submits, so a short lease is
    a transient inventory race to retry — never a silent partial grant.
    """


class RTS(ABC):
    """Abstract runtime system.

    Submissions are asynchronous; completions arrive on the registered
    callback from an RTS-internal thread. ``in_flight()`` must return the
    uids the RTS currently owns — after a failure, EnTK resubmits exactly
    that set ("loosing only those tasks that were in execution at the time
    of the RTS failure").
    """

    def __init__(self) -> None:
        self._callback: Optional[CompletionCallback] = None
        self._cb_lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------#

    @abstractmethod
    def start(self, resources: ResourceDescription) -> Pilot:
        """Acquire resources (may block until the pilot is active)."""

    @abstractmethod
    def stop(self) -> None:
        """Tear down; must purge any leftover workers (idempotent)."""

    @abstractmethod
    def alive(self) -> bool:
        """Heartbeat probe. False/exception ⇒ EnTK declares RTS failure."""

    # -- execution ------------------------------------------------------------#

    @abstractmethod
    def submit(self, tasks: List[Task]) -> None:
        """Accept tasks for execution (non-blocking)."""

    @abstractmethod
    def cancel(self, uids: List[str]) -> None:
        """Best-effort cancellation of submitted tasks."""

    @abstractmethod
    def in_flight(self) -> List[str]:
        """Uids submitted but not yet reported complete."""

    # -- capacity (slot-aware submission) -------------------------------------#

    def free_slots(self) -> Optional[int]:
        """Slots not currently occupied by running tasks, or ``None`` when
        the backend cannot (or should not) report wallclock capacity.

        The ExecManager uses this to pack its submission backlog into the
        pilot with largest-fit backfill instead of blind FIFO. Returning
        ``None`` opts out: the Emgr then drains its backlog FIFO exactly as
        the pre-slot-aware toolkit did. New RTS backends should implement
        this whenever their slot occupancy is meaningful in wallclock time.
        """
        return None

    # -- fusion (batched execution of homogeneous groups) ---------------------#

    def supports_fusion(self) -> bool:
        """True when this runtime executes congruent tasks (equal
        ``_fusion_group`` tags, see :mod:`repro.fusion`) as batched device
        dispatches. The ExecManager then hands it whole fusible groups,
        charging pilot slots per batch instead of per member. Backends that
        run every task in its own worker must keep the default False —
        advertising fusion without batching would let the Emgr submit far
        past their real capacity."""
        return False

    def planned_group_slots(self, n_members: int, member_slots: int) -> int:
        """Slots one fusible group of ``n_members`` will occupy if handed
        over right now. The default is the historical per-batch charge of
        one member's width; a backend that executes wide groups as SPMD
        sharded dispatches overrides this so the ExecManager charges the
        whole mesh when packing its submission backlog."""
        return member_slots

    # -- elasticity (beyond paper: required for 1000+-node operation) ---------#

    def resize(self, slots: int) -> int:  # pragma: no cover - optional
        """Grow/shrink the pilot; returns the slot count actually granted
        (a backend may clamp, e.g. to its physical device inventory).
        Default: unsupported."""
        raise NotImplementedError(f"{type(self).__name__} is not elastic")

    # -- callback plumbing ------------------------------------------------------#

    def set_callback(self, cb: Optional[CompletionCallback]) -> None:
        with self._cb_lock:
            self._callback = cb

    def _deliver(self, completion: TaskCompletion) -> None:
        with self._cb_lock:
            cb = self._callback
        if cb is not None:
            cb(completion)
