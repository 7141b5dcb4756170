"""FederatedRTS: one RTS facade over N heterogeneous member pilots.

The paper's requirements (ii) heterogeneous infrastructures and (iv) fault
tolerance meet here: a single workflow executes across a *fleet* of pilots —
any mix of :class:`~repro.rts.local.LocalRTS`, :class:`~repro.rts.jax_rts.JaxRTS`
and :class:`~repro.rts.simulated.SimulatedRTS` — behind the unchanged
:class:`~repro.rts.base.RTS` contract, so the ExecManager needs no special
case to drive a mixed CPU-pool + device-pool run.

Placement
---------
Tasks carry an optional ``backend`` affinity (:class:`~repro.core.pst.Task`):
set, it pins the task to the named member (hard affinity — a device-shaped
task must not spill to a CPU pool); unset, the task goes to the least-loaded
member. Hard affinity is honoured even through failure: a task pinned to a
*quarantined* member is parked (without blocking anything else) until the
member is re-admitted or rebuilt — if the member never recovers and has no
restart budget, the pinned task waits until the workflow's own timeout, by
design (the user asked for that member; spilling would run device-shaped
work on the wrong pool). Pin with a ``member_restarts`` budget, a workflow
timeout sized to tolerate the wait, or not at all. Only a pin to a member
the federation has *never* heard of fails fast (exit 2). The slot-aware ExecManager does the real packing: it reads
:meth:`member_slots` and pre-places each task (``task.tags['_fed_member']``)
with largest-fit backfill *within* a member and least-loaded spill *across*
members; :meth:`submit` honours the placement tag and falls back to its own
least-loaded choice for untagged submissions (RTS-restart resubmission,
speculative clones, direct use).

Failover (requirement iv at the RTS layer)
------------------------------------------
A monitor thread heartbeats every member. A member that misses
``heartbeat_misses`` consecutive probes is **quarantined**: its callback is
detached, its in-flight tasks are converted into synthetic
``pilot_lost`` completions (see :class:`~repro.rts.base.TaskCompletion`) that
the WFProcessor re-journals as FAILED-with-requeue — *without* consuming the
task's own retry budget — and resubmits onto surviving members through the
normal pending-queue path. A quarantined member keeps being probed and is
re-admitted when its pilot answers again (stale work is cancelled first); a
``member_restarts`` budget optionally rebuilds a dead member from its factory
instead of waiting. Only when *every* member is quarantined does
:meth:`alive` report failure, escalating to the ExecManager's whole-RTS
restart path.

Everything stays event-driven: completions flow through per-member callbacks,
capacity aggregation is pull-based (:meth:`free_slots`/:meth:`member_slots`),
and re-admission fires a capacity callback so the Emgr re-evaluates its
backlog without polling. The monitor is a liveness heartbeat (bounded work
per interval), the same pattern as the ExecManager's own RTS heartbeat.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core import uid as uidgen
from ..core.exceptions import ValueError_
from ..core.pst import Task
from .base import RTS, Pilot, ResourceDescription, TaskCompletion


@dataclasses.dataclass
class MemberSpec:
    """Description of one federation member: a name, an RTS factory and the
    resource description its pilot is started with."""

    name: str
    factory: Callable[[], RTS]
    resources: ResourceDescription


class _Member:
    __slots__ = ("spec", "rts", "pilot", "granted", "quarantined", "misses",
                 "restarts_used", "inflight", "tasks_run")

    def __init__(self, spec: MemberSpec) -> None:
        self.spec = spec
        self.rts: Optional[RTS] = None
        self.pilot: Optional[Pilot] = None
        self.granted = 0
        self.quarantined = False
        self.misses = 0
        self.restarts_used = 0
        self.inflight: Dict[str, int] = {}   # uid -> slots, in member custody
        self.tasks_run = 0

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def active(self) -> bool:
        return self.rts is not None and not self.quarantined


class FederatedRTS(RTS):
    """N member pilots behind one RTS interface.

    ``members`` — the fleet description (unique names required).
    ``heartbeat_interval`` / ``heartbeat_misses`` — member-level liveness.
    ``member_restarts`` — per-member budget for rebuilding a dead member from
    its factory (0 = quarantine only, re-admit on spontaneous recovery).
    """

    def __init__(
        self,
        members: Sequence[MemberSpec],
        heartbeat_interval: float = 0.25,
        heartbeat_misses: int = 2,
        member_restarts: int = 0,
    ) -> None:
        super().__init__()
        if not members:
            raise ValueError_("FederatedRTS requires at least one member")
        names = [m.name for m in members]
        if len(names) != len(set(names)):
            raise ValueError_(f"duplicate member names: {names}")
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_misses = max(1, heartbeat_misses)
        self.member_restarts = member_restarts
        self.members: List[_Member] = [_Member(s) for s in members]
        self._by_name: Dict[str, _Member] = {m.name: m for m in self.members}
        self._owner: Dict[str, _Member] = {}     # uid -> member custody
        self._unplaced: List[Task] = []          # no placeable member (yet)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.pilot: Optional[Pilot] = None
        self._started = False
        # capacity-change hook: the ExecManager registers a kick so member
        # re-admission wakes its backlog re-evaluation (no polling)
        self._capacity_cb: Optional[Callable[[], None]] = None
        # stats / observability
        self.members_lost = 0
        self.members_readmitted = 0
        self.members_restarted = 0
        self.pilot_lost_requeues = 0
        self.stale_completions = 0
        self.component_errors: List[str] = []

    # -- lifecycle ----------------------------------------------------------#

    def start(self, resources: ResourceDescription) -> Pilot:
        """Start every member pilot; ``resources`` (the aggregate description
        the ExecManager passes) is informational — each member is started
        with its own spec's description. The returned pilot reports the
        aggregate *granted* slot count."""
        self._stop.clear()
        for m in self.members:
            self._start_member(m)
        total = sum(m.granted for m in self.members)
        self.pilot = Pilot(
            uid=uidgen.generate("pilot"),
            description=dataclasses.replace(
                resources, slots=total, platform="federated",
                extra=dict(resources.extra)),
            started_at=time.time())
        self._started = True
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="fed-monitor", daemon=True)
        self._monitor.start()
        return self.pilot

    def _start_member(self, m: _Member) -> None:
        m.rts = m.spec.factory()
        m.rts.set_callback(self._member_callback(m))
        # the spec's description is the durable intent: hand the pilot a
        # copy so in-place bookkeeping (e.g. resize) never corrupts what a
        # member restart will be started with
        rd = m.spec.resources
        pilot = m.rts.start(dataclasses.replace(rd, extra=dict(rd.extra)))
        m.pilot = pilot
        granted = getattr(getattr(pilot, "description", None), "slots", None)
        m.granted = granted if isinstance(granted, int) and granted > 0 \
            else m.spec.resources.slots
        m.quarantined = False
        m.misses = 0

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        for m in self.members:
            if m.rts is not None:
                try:
                    m.rts.set_callback(None)
                    m.rts.stop()
                except Exception:  # noqa: BLE001 - teardown must not throw
                    pass
        with self._lock:
            self._owner.clear()
            self._unplaced.clear()
        self._started = False
        if self.pilot is not None:
            self.pilot.active = False

    def alive(self) -> bool:
        """The federation is alive while any member is serving; all-members
        death escalates to the ExecManager's whole-RTS restart."""
        if not self._started:
            return False
        return any(m.active for m in self.members)

    def resize(self, slots: int) -> int:
        """Best-effort proportional resize across resizable members; returns
        the aggregate granted slot count."""
        total_now = sum(m.granted for m in self.members if m.active) or 1
        granted = 0
        for m in self.members:
            if not m.active:
                continue
            target = max(1, round(slots * m.granted / total_now))
            try:
                m.granted = m.rts.resize(target)
            except NotImplementedError:
                pass
            except Exception:  # noqa: BLE001 - monitor handles a dying member
                pass
            granted += m.granted
        if self.pilot is not None:
            self.pilot.description.slots = granted
        return granted

    # -- capacity ----------------------------------------------------------#

    def _member_free(self, m: _Member) -> int:
        try:
            free = m.rts.free_slots()
        except Exception:  # noqa: BLE001 - dying member: monitor handles it
            return 0
        if free is None:
            # backend opts out of wallclock capacity (e.g. SimulatedRTS's
            # virtual clock): account slots ourselves from custody width
            free = m.granted - sum(m.inflight.values())
        return max(0, free)

    def free_slots(self) -> Optional[int]:
        """Aggregate free slots over active members (never ``None``: the
        federation always packs slot-aware, even over opt-out members)."""
        with self._lock:
            return sum(self._member_free(m) for m in self.members if m.active)

    def member_slots(self) -> Dict[str, Tuple[int, int]]:
        """``{member_name: (free, total)}`` for active members — the
        ExecManager's placement-aware packer input."""
        with self._lock:
            return {m.name: (self._member_free(m), m.granted)
                    for m in self.members if m.active}

    def member_names(self) -> List[str]:
        """Every member name, active or quarantined (affinity validation)."""
        return list(self._by_name)

    def supports_fusion(self) -> bool:
        """A federation fuses when any member does; :meth:`fusion_members`
        tells the Emgr *which* members, so whole-group pinning only ever
        targets a pilot that will actually batch the group."""
        return bool(self.fusion_members())

    def fusion_members(self) -> "set[str]":
        """Names of members whose runtime batches fused groups. The Emgr's
        placement-aware packer drains a fusible group onto one member —
        charging its slots once — ONLY when that member is in this set; a
        group landing on a scalar member is placed (and charged) task by
        task like any other work, since that pilot runs it task by task."""
        out = set()
        for m in self.members:
            try:
                if m.rts is not None and m.rts.supports_fusion():
                    out.add(m.name)
            except Exception:  # noqa: BLE001 - dying member: monitor's job
                pass
        return out

    def set_capacity_callback(self, cb: Optional[Callable[[], None]]) -> None:
        self._capacity_cb = cb

    def _kick_capacity(self) -> None:
        cb = self._capacity_cb
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001
                pass

    # -- execution ----------------------------------------------------------#

    def submit(self, tasks: List[Task]) -> None:
        """Route each task to a member: the ExecManager's placement tag
        first, then hard ``backend`` affinity, then least-loaded spill."""
        per_member: Dict[str, List[Task]] = {}
        rejected: List[Task] = []
        with self._lock:
            free = {m.name: self._member_free(m)
                    for m in self.members if m.active}
            for task in tasks:
                m = self._place_locked(task, free)
                if m is None:
                    rejected.append(task)
                    continue
                if m is _PARK:
                    self._unplaced.append(task)
                    continue
                free[m.name] = free.get(m.name, 0) - task.slots
                m.inflight[task.uid] = task.slots
                m.tasks_run += 1
                self._owner[task.uid] = m
                per_member.setdefault(m.name, []).append(task)
        for name, batch in per_member.items():
            member = self._by_name[name]
            try:
                member.rts.submit(batch)
            except Exception:  # noqa: BLE001 - dying member: quarantine now
                self.component_errors.append(
                    f"submit[{name}]: {traceback.format_exc(limit=5)}")
                self._quarantine(member)
        now = time.time()
        for task in rejected:
            # affinity to a member that does not exist: the task could never
            # run — fail it immediately (same contract as the JaxRTS
            # wider-than-inventory rejection) instead of hanging the run
            self._deliver(TaskCompletion(
                uid=task.uid, exit_code=2,
                exception=(f"task {task.name} pinned to unknown federation "
                           f"member {task.backend!r}; members: "
                           f"{sorted(self._by_name)}"),
                started_at=now, completed_at=now))

    def _place_locked(self, task: Task, free: Dict[str, int]):
        """Pick a member for one task; ``None`` = reject (unknown affinity),
        ``_PARK`` = hold until a member becomes available."""
        hint = task.tags.get("_fed_member")
        if hint is not None:
            m = self._by_name.get(hint)
            if m is not None and m.active:
                return m
            task.tags.pop("_fed_member", None)  # stale Emgr placement
        if task.backend is not None:
            m = self._by_name.get(task.backend)
            if m is None:
                return None
            return m if m.active else _PARK  # quarantined: may come back
        candidates = [m for m in self.members if m.active]
        if not candidates:
            return _PARK
        # least-loaded spill, slot-aware: prefer a member the task fits in
        # right now, then one whose pilot is at least wide enough to ever
        # run it (it queues there), then the widest member — a JaxRTS-style
        # backend rejects an impossible width itself, and routing it to the
        # widest pilot keeps that rejection (not capacity noise) the reason
        fit = [m for m in candidates if free.get(m.name, 0) >= task.slots]
        if fit:
            return max(fit, key=lambda m: free.get(m.name, 0))
        capable = [m for m in candidates if m.granted >= task.slots]
        if capable:
            return max(capable, key=lambda m: free.get(m.name, 0))
        return max(candidates, key=lambda m: m.granted)

    def cancel(self, uids: List[str]) -> None:
        per_member: Dict[str, List[str]] = {}
        with self._lock:
            wanted = set(uids)
            self._unplaced = [t for t in self._unplaced
                              if t.uid not in wanted]
            for u in uids:
                m = self._owner.get(u)
                if m is not None:
                    per_member.setdefault(m.name, []).append(u)
        for name, batch in per_member.items():
            try:
                self._by_name[name].rts.cancel(batch)
            except Exception:  # noqa: BLE001
                pass

    def in_flight(self) -> List[str]:
        with self._lock:
            return list(self._owner) + [t.uid for t in self._unplaced]

    def running_since(self) -> Dict[str, float]:
        """Aggregate straggler-watchdog input over members that report it."""
        out: Dict[str, float] = {}
        for m in self.members:
            if not m.active or not hasattr(m.rts, "running_since"):
                continue
            try:
                out.update(m.rts.running_since())
            except Exception:  # noqa: BLE001
                pass
        return out

    # -- completion plumbing -------------------------------------------------#

    def _member_callback(self, m: _Member) -> Callable[[TaskCompletion], None]:
        def cb(c: TaskCompletion) -> None:
            with self._lock:
                owner = self._owner.get(c.uid)
                if owner is not m:
                    # stale: the task was requeued at quarantine (or already
                    # completed elsewhere) — this attempt no longer counts
                    self.stale_completions += 1
                    return
                del self._owner[c.uid]
                m.inflight.pop(c.uid, None)
            self._deliver(c)
        return cb

    # -- failover ------------------------------------------------------------#

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.heartbeat_interval)
            if self._stop.is_set():
                return
            try:
                self._probe_members()
            except Exception:  # noqa: BLE001 - monitor must survive anything
                self.component_errors.append(
                    f"monitor: {traceback.format_exc(limit=5)}")

    def _probe_members(self) -> None:
        for m in self.members:
            try:
                ok = m.rts is not None and m.rts.alive()
            except Exception:  # noqa: BLE001 - a dead pilot may throw anything
                ok = False
            if m.quarantined:
                if ok:
                    self._readmit(m)
                elif m.restarts_used < self.member_restarts:
                    self._restart_member(m)
                continue
            if ok:
                m.misses = 0
                continue
            m.misses += 1
            if m.misses >= self.heartbeat_misses:
                self._quarantine(m)

    def _quarantine(self, m: _Member) -> None:
        """Declare ``m``'s pilot lost: detach it, requeue its in-flight work
        onto the surviving members via synthetic ``pilot_lost`` completions.
        The member RTS is *not* stopped — a transiently-hung pilot may answer
        again, and re-admission cancels its stale work first."""
        with self._lock:
            if m.quarantined:
                return
            m.quarantined = True
            m.misses = 0
            lost = list(m.inflight)
            m.inflight.clear()
            for u in lost:
                self._owner.pop(u, None)
            self.members_lost += 1
            self.pilot_lost_requeues += len(lost)
        try:
            m.rts.set_callback(None)
        except Exception:  # noqa: BLE001
            pass
        now = time.time()
        for u in lost:
            self._deliver(TaskCompletion(
                uid=u, exit_code=-3, pilot_lost=True,
                exception=f"pilot lost: federation member {m.name}",
                started_at=now, completed_at=now))

    def _restart_member(self, m: _Member) -> None:
        """Rebuild a dead member from its factory (restart budget)."""
        m.restarts_used += 1
        old = m.rts
        try:
            if old is not None:
                old.set_callback(None)
                old.stop()
        except Exception:  # noqa: BLE001
            pass
        try:
            self._start_member(m)
        except Exception:  # noqa: BLE001 - still dead: stay quarantined
            self.component_errors.append(
                f"restart[{m.name}]: {traceback.format_exc(limit=5)}")
            m.quarantined = True
            return
        self.members_restarted += 1
        self._after_readmission(m)

    def _readmit(self, m: _Member) -> None:
        """A quarantined pilot answers again: flush its stale work (those
        tasks were already requeued elsewhere) and put it back in rotation."""
        try:
            stale = m.rts.in_flight()
            if stale:
                m.rts.cancel(stale)
        except Exception:  # noqa: BLE001 - not actually recovered
            return
        m.rts.set_callback(self._member_callback(m))
        with self._lock:
            m.quarantined = False
            m.misses = 0
        self.members_readmitted += 1
        self._after_readmission(m)

    def _after_readmission(self, m: _Member) -> None:
        """Dispatch parked affinity tasks and announce the new capacity."""
        with self._lock:
            ready = [t for t in self._unplaced
                     if t.backend in (None, m.name)]
            self._unplaced = [t for t in self._unplaced if t not in ready]
        if ready:
            self.submit(ready)
        self._kick_capacity()


class _Park:
    """Sentinel: hold the task until a member becomes available."""


_PARK = _Park()
