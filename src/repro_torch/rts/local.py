"""LocalRTS: a thread-pool pilot with device-slot scheduling.

This is the concrete runtime used for integration tests, the examples, and
small real runs on the container. It honours the full RTS contract:

* slot-aware FIFO scheduling (a task occupies ``task.slots`` slots for its
  lifetime; submissions beyond capacity queue),
* ``sleep://<s>`` synthetic executables and registered/raw callables,
* POSIX-``cp`` data staging (the paper's staging mechanism) with measured
  staging time per task,
* failure injection (``fault_injector``) and straggler injection
  (``straggler_injector``) hooks for the fault-tolerance experiments,
* cooperative cancellation, liveness probe, purge-on-stop, and elastic
  ``resize``.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional

from .. import telemetry as tel
from ..core import uid as uidgen
from ..core.pst import Task
from .base import (RTS, Pilot, RequeueTask, ResourceDescription,
                   TaskCompletion)


class _Running:
    __slots__ = ("task", "thread", "started_at", "cancel_event", "speculative")

    def __init__(self, task: Task, thread: threading.Thread,
                 cancel_event: threading.Event) -> None:
        self.task = task
        self.thread = thread
        self.started_at = time.monotonic()
        self.cancel_event = cancel_event
        self.speculative = bool(task.tags.get("speculative_of"))


class LocalRTS(RTS):
    """Thread-pool runtime with slot accounting.

    ``fault_injector(task) -> bool`` — return True to make the task fail
    (exit code 1) without running its payload; used to reproduce the paper's
    CI-failure experiments deterministically.

    ``straggler_injector(task) -> float`` — extra seconds to stall the task;
    exercises the ExecManager's speculative re-execution watchdog.
    """

    def __init__(
        self,
        fault_injector: Optional[Callable[[Task], bool]] = None,
        straggler_injector: Optional[Callable[[Task], float]] = None,
        staging_root: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.fault_injector = fault_injector
        self.straggler_injector = straggler_injector
        self.staging_root = staging_root
        self.pilot: Optional[Pilot] = None
        self._slots_total = 0
        self._slots_free = 0
        self._queue: deque = deque()
        self._running: Dict[str, _Running] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._scheduler: Optional[threading.Thread] = None
        self._alive = False
        # test hook: when set, alive() returns False (simulated RTS hang/death)
        self.simulate_dead = False

    # -- lifecycle ----------------------------------------------------------#

    def start(self, resources: ResourceDescription) -> Pilot:
        self._stop.clear()
        self.simulate_dead = False
        self._slots_total = resources.slots
        self._slots_free = resources.slots
        self.pilot = Pilot(uid=uidgen.generate("pilot"), description=resources,
                           started_at=time.time())
        self._scheduler = threading.Thread(
            target=self._schedule_loop, name="rts-scheduler", daemon=True)
        self._alive = True
        self._scheduler.start()
        return self.pilot

    def stop(self) -> None:
        self._stop.set()
        with self._work:
            self._work.notify_all()
            running = list(self._running.values())
            self._queue.clear()
        for r in running:
            r.cancel_event.set()
        if self._scheduler is not None:
            self._scheduler.join(timeout=5.0)
            self._scheduler = None
        # purge: wait briefly for workers, then abandon (daemon threads)
        for r in running:
            r.thread.join(timeout=1.0)
        with self._lock:
            self._running.clear()
        self._alive = False
        if self.pilot is not None:
            self.pilot.active = False

    def alive(self) -> bool:
        if self.simulate_dead:
            return False
        return self._alive and (self._scheduler is not None
                                and self._scheduler.is_alive())

    def resize(self, slots: int) -> int:
        """Elastic pilot resize; queued work is rescheduled on the new size."""
        with self._work:
            delta = slots - self._slots_total
            self._slots_total = slots
            self._slots_free += delta
            self._work.notify_all()
        if self.pilot is not None:
            self.pilot.description.slots = slots
        return slots

    # -- execution ------------------------------------------------------------#

    def submit(self, tasks: List[Task]) -> None:
        with self._work:
            for t in tasks:
                self._queue.append(t)
            self._work.notify_all()

    def cancel(self, uids: List[str]) -> None:
        wanted = set(uids)
        with self._work:
            self._queue = deque(t for t in self._queue if t.uid not in wanted)
            for u in wanted:
                r = self._running.get(u)
                if r is not None:
                    r.cancel_event.set()

    def in_flight(self) -> List[str]:
        with self._lock:
            return [t.uid for t in self._queue] + list(self._running)

    def free_slots(self) -> Optional[int]:
        """Unoccupied slots (slot-aware Emgr submission)."""
        with self._lock:
            return max(0, self._slots_free)

    def running_since(self) -> Dict[str, float]:
        """uid -> seconds running (ExecManager straggler watchdog input)."""
        now = time.monotonic()
        with self._lock:
            return {u: now - r.started_at for u, r in self._running.items()}

    # -- internals ------------------------------------------------------------#

    def _can_start(self, task: Task) -> bool:
        """Subclass eligibility hook, checked beyond slot arithmetic (e.g.
        the JaxRTS requires enough physical devices in its lease pool)."""
        return True

    def _schedule_loop(self) -> None:
        while not self._stop.is_set():
            with self._work:
                task = None
                # FIFO with first-fit skip: find first task that fits free slots
                for i, cand in enumerate(self._queue):
                    if cand.slots <= self._slots_free and self._can_start(cand):
                        task = cand
                        del self._queue[i]
                        break
                if task is None:
                    self._work.wait(timeout=0.05)
                    continue
                span = tel.span("rts.schedule", "rts", uid=task.uid)
                self._slots_free -= task.slots
                cancel_event = threading.Event()
                worker = threading.Thread(
                    target=self._run_task, args=(task, cancel_event),
                    name=f"rts-worker-{task.uid}", daemon=True)
                self._running[task.uid] = _Running(task, worker, cancel_event)
            worker.start()
            span.end()

    def _release(self, task: Task) -> None:
        with self._work:
            self._running.pop(task.uid, None)
            self._slots_free += task.slots
            self._work.notify_all()

    def _requeue(self, task: Task) -> None:
        """Return a RequeueTask-raising task to the queue — at the FRONT.

        It held the head position when it was scheduled; re-entering at the
        back would let a steady stream of narrow tasks overtake a wide one
        on every lease race, starving it indefinitely (the ``_can_start``
        skip already lets narrow work run while it waits)."""
        with self._work:
            self._queue.appendleft(task)
            self._work.notify_all()

    def _run_task(self, task: Task, cancel_event: threading.Event) -> None:
        started = time.time()
        staging_s = 0.0
        exit_code = 0
        result = None
        requeue = False
        exc: Optional[str] = None
        # the task's spans on this thread inherit its uid from this one; the
        # wait since the ExecManager's submit is an attribute, not a range
        running = tel.span("rts.task", "rts", uid=task.uid,
                           executable=task.executable,
                           queued_ns=(None if task.submitted_at is None else
                                      int((started - task.submitted_at)
                                          * 1e9)))
        try:
            if cancel_event.is_set():
                exit_code = -2
            elif self.fault_injector is not None and self.fault_injector(task):
                exit_code = 1
                exc = "injected fault"
            else:
                staging_s = self._stage(task.copy_input_data)
                stall = (self.straggler_injector(task)
                         if self.straggler_injector else 0.0)
                exit_code, result, exc = self._execute(
                    task, cancel_event, stall)
                if exit_code == 0:
                    staging_s += self._stage(task.copy_output_data)
        except RequeueTask:
            # transient resource race (e.g. device-lease shortage): the task
            # goes back in the queue and no completion is delivered
            requeue = True
        except Exception:  # noqa: BLE001 - RTS must never crash on a task
            exit_code = 1
            exc = traceback.format_exc(limit=10)
        finally:
            running.end()
            delivering = tel.span("rts.deliver", "rts", uid=task.uid)
            self._release(task)
        with delivering:
            if requeue:
                if not self._stop.is_set():
                    self._requeue(task)
                return
            self._deliver(TaskCompletion(
                uid=task.uid, exit_code=exit_code, result=result,
                exception=exc, started_at=started, completed_at=time.time(),
                staging_seconds=staging_s,
                execution_seconds=time.time() - started - staging_s))

    def _execute(self, task: Task, cancel_event: threading.Event,
                 stall: float):
        if task.executable.startswith("sleep://"):
            duration = float(task.executable[len("sleep://"):]) + stall
            deadline = time.monotonic() + duration
            while time.monotonic() < deadline:
                if cancel_event.is_set():
                    return -2, None, None
                time.sleep(min(0.02, deadline - time.monotonic()))
            return 0, None, None
        fn = task.resolve()
        if stall > 0:
            deadline = time.monotonic() + stall
            while time.monotonic() < deadline:
                if cancel_event.is_set():
                    return -2, None, None
                time.sleep(min(0.02, deadline - time.monotonic()))
        if cancel_event.is_set():
            return -2, None, None
        kwargs = dict(task.kwargs)
        # cooperative cancellation for callables that declare the parameter
        # (parameters only — co_varnames alone would also match body locals)
        code = getattr(fn, "__code__", None)
        if code is not None and "_cancel_event" in code.co_varnames[
                :code.co_argcount + code.co_kwonlyargcount]:
            kwargs["_cancel_event"] = cancel_event
        try:
            result = fn(*task.args, **kwargs)
            return 0, result, None
        except Exception:  # noqa: BLE001
            return 1, None, traceback.format_exc(limit=10)

    def _stage(self, directives: List[str]) -> float:
        """POSIX-cp staging: each directive is ``src`` or ``src>dst``."""
        if not directives:
            return 0.0
        t0 = time.perf_counter()
        for directive in directives:
            if ">" in directive:
                src, dst = (s.strip() for s in directive.split(">", 1))
            else:
                src, dst = directive, os.path.basename(directive)
            if self.staging_root is not None and not os.path.isabs(dst):
                dst = os.path.join(self.staging_root, dst)
            os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy(src, dst)
        return time.perf_counter() - t0
