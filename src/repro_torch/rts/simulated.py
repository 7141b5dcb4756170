"""SimulatedRTS: discrete-event runtime with a virtual clock.

The paper's scalability experiments (Figs. 8–9) run up to 8,192 Gromacs tasks
of ≈600 s each on Titan — hours of wallclock. This RTS reproduces the
*scheduling dynamics* (slot contention, per-task submission and collection
latency, staging throughput, generations of tasks) in virtual time so the
benchmarks execute in milliseconds while reporting the same task-execution /
staging / RTS-overhead decomposition. EnTK-side overheads remain *real*
measured time — exactly the split the paper uses (EnTK runs on a login node,
tasks on the CI).

Determinism: a seeded RNG drives failure injection, so every benchmark run
is reproducible.
"""

from __future__ import annotations

import heapq
import itertools
import random
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

_wall = _time.monotonic

from ..core import uid as uidgen
from ..core.pst import Task
from .base import RTS, Pilot, ResourceDescription, TaskCompletion
from .platforms import PlatformProfile, get_platform

_ARRIVE, _START, _FINISH = 0, 1, 2


class SimulatedRTS(RTS):
    """Event-driven pilot simulation.

    Task durations come from ``sleep://<s>`` executables or
    ``task.duration_hint``. Staging cost = per-file latency + bytes/bandwidth
    (``task.tags['staging_files'/'staging_bytes']``). Failures: platform
    ``failure_rate`` or per-task ``task.tags['fail_prob']`` /
    ``task.tags['fail_first_n']`` (fail the first n attempts — lets tests
    script resubmission behaviour deterministically).
    """

    def __init__(self, seed: int = 0) -> None:
        super().__init__()
        self._rng = random.Random(seed)
        self.profile: Optional[PlatformProfile] = None
        self.pilot: Optional[Pilot] = None
        self.vnow = 0.0  # virtual clock, seconds since pilot start
        self._slots_total = 0
        self._slots_free = 0
        self._events: List[Tuple[float, int, int, Optional[Task]]] = []
        self._waiting: List[Task] = []
        self._running: Dict[str, Task] = {}
        self._pending_arrivals: List[Task] = []
        self._attempts: Dict[str, int] = {}
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()
        self.simulate_dead = False
        # The virtual clock must not jump forward while EnTK is still
        # streaming submissions (a real CI cannot either: the pilot exists in
        # wallclock). Hold time-jumps until no submission arrived for
        # ``hold_s`` real seconds.
        self.hold_s = 0.05
        self._last_arrival_wall = 0.0
        # stats for benchmarks
        self.virtual_makespan = 0.0
        self.total_task_seconds = 0.0
        self.total_staging_seconds = 0.0
        self.tasks_completed = 0
        self.tasks_failed = 0

    # -- lifecycle ----------------------------------------------------------#

    def start(self, resources: ResourceDescription) -> Pilot:
        self.profile = get_platform(resources.platform)
        self._slots_total = resources.slots
        self._slots_free = resources.slots
        self.vnow = self.profile.rts_bootstrap
        self._stop.clear()
        self.pilot = Pilot(uid=uidgen.generate("pilot"), description=resources)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="simrts-loop")
        self._thread.start()
        return self.pilot

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.profile is not None:
            self.virtual_makespan = self.vnow + self.profile.rts_teardown

    def alive(self) -> bool:
        if self.simulate_dead:
            return False
        return self._thread is not None and self._thread.is_alive()

    def resize(self, slots: int) -> int:
        with self._cv:
            self._slots_free += slots - self._slots_total
            self._slots_total = slots
            self._cv.notify_all()
        return slots

    # -- execution ------------------------------------------------------------#

    def submit(self, tasks: List[Task]) -> None:
        with self._cv:
            self._pending_arrivals.extend(tasks)
            self._last_arrival_wall = _wall()
            self._idle.clear()
            self._cv.notify_all()

    def cancel(self, uids: List[str]) -> None:
        wanted = set(uids)
        with self._cv:
            self._waiting = [t for t in self._waiting if t.uid not in wanted]
            self._pending_arrivals = [t for t in self._pending_arrivals
                                      if t.uid not in wanted]
            # running tasks: drop their finish events lazily via tombstones
            for u in wanted & set(self._running):
                self._running.pop(u)
                self._slots_free += 1  # approximation: canceled slot frees now

    def in_flight(self) -> List[str]:
        with self._cv:
            return ([t.uid for t in self._pending_arrivals]
                    + [t.uid for t in self._waiting] + list(self._running))

    def free_slots(self) -> Optional[int]:
        """Opt out of slot-aware submission: slot occupancy here lives on
        the *virtual* clock, so throttling wallclock submission against it
        would only serialize arrivals and perturb the deterministic replay.
        Returning None makes the Emgr drain FIFO, exactly like the paper's
        measured EnTK (submit everything, let the pilot queue)."""
        return None

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until the simulation has no outstanding work (benchmarks)."""
        return self._idle.wait(timeout)

    # -- simulation ---------------------------------------------------------#

    def _duration(self, task: Task) -> float:
        if task.executable.startswith("sleep://"):
            base = float(task.executable[len("sleep://"):])
        elif task.duration_hint is not None:
            base = float(task.duration_hint)
        else:
            base = 0.0
        return base + self.profile.executor_overhead

    def _staging(self, task: Task) -> float:
        files = int(task.tags.get("staging_files", 0))
        nbytes = float(task.tags.get("staging_bytes", 0.0))
        if files == 0 and nbytes == 0.0:
            return 0.0
        return (files * self.profile.staging_latency
                + nbytes / self.profile.staging_bandwidth)

    def _fails(self, task: Task) -> bool:
        attempt = self._attempts.get(task.name, 0)
        self._attempts[task.name] = attempt + 1
        first_n = int(task.tags.get("fail_first_n", 0))
        if attempt < first_n:
            return True
        p = float(task.tags.get("fail_prob", self.profile.failure_rate))
        return p > 0 and self._rng.random() < p

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                # fold in new arrivals at current virtual time + submit latency
                if self._pending_arrivals:
                    for task in self._pending_arrivals:
                        arrive_at = self.vnow + self.profile.task_submit_latency
                        heapq.heappush(self._events,
                                       (arrive_at, _ARRIVE, next(self._seq),
                                        task))
                    self._pending_arrivals.clear()
                if not self._events and not self._waiting:
                    if not self._running:
                        self._idle.set()
                    self._cv.wait(timeout=0.05)
                    continue
                # start waiting tasks if slots free (FIFO first-fit)
                started_any = self._try_start_locked()
                if started_any:
                    continue
                if not self._events:
                    # waiting tasks but no capacity and nothing in flight ⇒
                    # deadlock by resource shortage; report as task failures
                    if not self._running and self._waiting:
                        stuck, self._waiting = self._waiting, []
                        completions = [self._complete(t, exit_code=2,
                                                      exc="insufficient slots")
                                       for t in stuck]
                    else:
                        self._cv.wait(timeout=0.05)
                        continue
                else:
                    when = self._events[0][0]
                    if (when > self.vnow + 1.0
                            and _wall() - self._last_arrival_wall
                            < self.hold_s):
                        # a time-jump while submissions may still be
                        # streaming in: hold the clock briefly
                        self._cv.wait(timeout=0.01)
                        continue
                    when, kind, _, task = heapq.heappop(self._events)
                    self.vnow = max(self.vnow, when)
                    completions = self._handle_locked(kind, task)
            for c in completions:
                self._deliver(c)

    def _try_start_locked(self) -> bool:
        started = False
        if self._slots_free <= 0 or not self._waiting:
            return started  # full pilot: don't scan the backlog at all
        i = 0
        while i < len(self._waiting):
            if self._slots_free <= 0:
                break
            task = self._waiting[i]
            if task.slots <= self._slots_free:
                del self._waiting[i]
                self._slots_free -= task.slots
                self._running[task.uid] = task
                stage_s = self._staging(task)
                dur = self._duration(task)
                finish_at = self.vnow + stage_s + dur
                task.tags["_sim_started"] = self.vnow
                task.tags["_sim_staging"] = stage_s
                heapq.heappush(self._events,
                               (finish_at, _FINISH, next(self._seq), task))
                started = True
            else:
                i += 1
        return started

    def _handle_locked(self, kind: int, task: Task) -> List[TaskCompletion]:
        if kind == _ARRIVE:
            self._waiting.append(task)
            return []
        if kind == _FINISH:
            if task.uid not in self._running:
                return []  # canceled while running
            self._running.pop(task.uid)
            self._slots_free += task.slots
            failed = self._fails(task)
            return [self._complete(task, exit_code=1 if failed else 0,
                                   exc="simulated CI failure" if failed
                                   else None)]
        return []

    def _complete(self, task: Task, exit_code: int,
                  exc: Optional[str]) -> TaskCompletion:
        started = float(task.tags.get("_sim_started", self.vnow))
        staging = float(task.tags.get("_sim_staging", 0.0))
        collect = self.profile.task_collect_latency
        self.vnow += collect
        exec_s = max(0.0, self.vnow - started - staging - collect)
        if exit_code == 0:
            self.tasks_completed += 1
            self.total_task_seconds += exec_s
            self.total_staging_seconds += staging
        else:
            self.tasks_failed += 1
        return TaskCompletion(
            uid=task.uid, exit_code=exit_code, result=None, exception=exc,
            started_at=started, completed_at=self.vnow,
            staging_seconds=staging, execution_seconds=exec_s)
