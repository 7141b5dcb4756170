"""The PST application model: Pipelines of Stages of Tasks (paper §II-B.1).

* **Task** — stand-alone computation with well-defined inputs, outputs,
  termination criteria and dedicated resources.
* **Stage** — a set of tasks with no mutual dependences (concurrent).
* **Pipeline** — a list of stages; stage *i* runs only after stage *i-1*.

All pipelines of an application run concurrently.  Branching/adaptivity does
not alter the PST semantics: a stage may carry a ``post_exec`` callback that,
once the stage reaches a final state, may append new stages to its pipeline
(the paper's "branching events specified as tasks where a decision is made").

Objects are plain Python with dict (de)serialization because EnTK copies
entities between components via queues and journals every transition; the
callable payload of a task is carried by reference through a process-local
registry so that descriptions remain serializable.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import states, uid
from .exceptions import MissingError, TypeError_, ValueError_

# --------------------------------------------------------------------------- #
# Executable registry
# --------------------------------------------------------------------------- #
# Tasks journaled to disk must be re-creatable on resume, so callables are
# registered under a name ("reg://<name>").  Unregistered raw callables are
# allowed for convenience but marked non-resumable.

_EXECUTABLE_REGISTRY: Dict[str, Callable[..., Any]] = {}
_registry_lock = threading.Lock()


def register_executable(name: str, fn: Callable[..., Any]) -> str:
    """Register ``fn`` under ``name``; returns the ``reg://`` uri for Task.executable."""
    with _registry_lock:
        _EXECUTABLE_REGISTRY[name] = fn
    return f"reg://{name}"


def registered_executable(name: str) -> Optional[Callable[..., Any]]:
    """The callable registered under ``name``, or None (no ``reg://`` prefix).

    Used by the declarative API to auto-register task functions without
    silently re-binding a name that already belongs to a different callable.
    """
    with _registry_lock:
        return _EXECUTABLE_REGISTRY.get(name)


def resolve_executable(ref: str) -> Callable[..., Any]:
    name = ref[len("reg://"):]
    with _registry_lock:
        try:
            return _EXECUTABLE_REGISTRY[name]
        except KeyError:
            raise MissingError(f"no executable registered under {name!r}") from None


# --------------------------------------------------------------------------- #
# Task
# --------------------------------------------------------------------------- #

class Task:
    """A computational task.

    ``executable`` is one of:

    * ``"sleep://<seconds>"`` — a synthetic task of fixed duration (the paper's
      ``sleep`` workload; honoured by Local and Simulated RTSes),
    * ``"reg://<name>"`` — a registered Python callable (journal-resumable),
    * a raw Python callable (convenient, not resumable across restarts).

    ``slots`` expresses the resource requirement in device-slots (the paper's
    cores-per-task, our TPU-devices-per-task). ``max_retries`` is the
    resubmission budget of the paper's failure model.

    ``backend`` is an optional placement affinity for federated execution: the
    name of the :class:`~repro.rts.federation.FederatedRTS` member the task
    must run on (e.g. a device pool vs a CPU pool in one mixed fleet). Unset
    means the task may run on any member (least-loaded spill).
    """

    __slots__ = (
        "uid", "name", "executable", "args", "kwargs", "slots",
        "duration_hint", "max_retries", "retries", "state", "state_history",
        "exit_code", "result", "exception", "upload_input_data",
        "copy_input_data", "copy_output_data", "tags", "backend",
        "parent_stage", "parent_pipeline", "submitted_at", "completed_at",
        "ns", "_fn",
    )

    def __init__(
        self,
        name: str = "",
        executable: Any = None,
        args: Sequence[Any] = (),
        kwargs: Optional[Dict[str, Any]] = None,
        slots: int = 1,
        duration_hint: Optional[float] = None,
        max_retries: int = 0,
        upload_input_data: Optional[List[str]] = None,
        copy_input_data: Optional[List[str]] = None,
        copy_output_data: Optional[List[str]] = None,
        tags: Optional[Dict[str, Any]] = None,
        backend: Optional[str] = None,
    ) -> None:
        if not isinstance(slots, int) or slots < 1:
            raise ValueError_(f"task slots must be a positive int, got {slots!r}")
        self.uid = uid.generate("task")
        self.name = name or self.uid
        self._fn: Optional[Callable[..., Any]] = None
        if callable(executable):
            self._fn = executable
            executable = f"callable://{getattr(executable, '__name__', 'anonymous')}"
        if executable is None:
            raise MissingError("task requires an executable")
        if not isinstance(executable, str):
            raise TypeError_(f"executable must be str|callable, got {type(executable)}")
        self.executable: str = executable
        self.args = list(args)
        self.kwargs = dict(kwargs or {})
        self.slots = slots
        self.duration_hint = duration_hint
        self.max_retries = max_retries
        self.retries = 0
        self.state = states.INITIAL
        self.state_history: List[Dict[str, Any]] = [
            {"state": states.INITIAL, "t": time.time()}
        ]
        self.exit_code: Optional[int] = None
        self.result: Any = None
        self.exception: Optional[str] = None
        self.upload_input_data = list(upload_input_data or [])
        self.copy_input_data = list(copy_input_data or [])
        self.copy_output_data = list(copy_output_data or [])
        self.tags = dict(tags or {})
        self.backend = backend
        self.parent_stage: Optional[str] = None
        self.parent_pipeline: Optional[str] = None
        self.submitted_at: Optional[float] = None
        self.completed_at: Optional[float] = None
        # Workflow namespace (api.compile mints one per workflow). Stamped by
        # the compiler; journal transitions carry it so a multi-tenant service
        # can route each record to the owning tenant's journal.
        self.ns: Optional[str] = None

    # -- state ------------------------------------------------------------- #

    def advance(self, to_state: str) -> None:
        states.validate_transition("task", self.uid, self.state, to_state)
        self.state = to_state
        self.state_history.append({"state": to_state, "t": time.time()})

    @property
    def is_final(self) -> bool:
        return self.state in states.TASK_FINAL

    @property
    def resumable(self) -> bool:
        return not self.executable.startswith("callable://")

    def resolve(self) -> Callable[..., Any]:
        """Return the callable this task runs (RTS-side)."""
        if self._fn is not None:
            return self._fn
        if self.executable.startswith("reg://"):
            return resolve_executable(self.executable)
        raise MissingError(f"task {self.uid} has no resolvable executable "
                           f"({self.executable!r})")

    # -- (de)serialization --------------------------------------------------#

    def to_dict(self) -> Dict[str, Any]:
        return {
            "uid": self.uid,
            "name": self.name,
            "executable": self.executable,
            "args": self.args,
            "kwargs": self.kwargs,
            "slots": self.slots,
            "duration_hint": self.duration_hint,
            "max_retries": self.max_retries,
            "retries": self.retries,
            "state": self.state,
            "exit_code": self.exit_code,
            "result": self.result,
            "exception": self.exception,
            "upload_input_data": self.upload_input_data,
            "copy_input_data": self.copy_input_data,
            "copy_output_data": self.copy_output_data,
            "tags": self.tags,
            "backend": self.backend,
            "parent_stage": self.parent_stage,
            "parent_pipeline": self.parent_pipeline,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Task":
        t = cls.__new__(cls)
        t._fn = None
        t.uid = d["uid"]
        t.name = d["name"]
        t.executable = d["executable"]
        t.args = list(d.get("args", ()))
        t.kwargs = dict(d.get("kwargs", {}))
        t.slots = d.get("slots", 1)
        t.duration_hint = d.get("duration_hint")
        t.max_retries = d.get("max_retries", 0)
        t.retries = d.get("retries", 0)
        t.state = d.get("state", states.INITIAL)
        t.state_history = [{"state": t.state, "t": time.time()}]
        t.exit_code = d.get("exit_code")
        t.result = d.get("result")
        t.exception = d.get("exception")
        t.upload_input_data = list(d.get("upload_input_data", ()))
        t.copy_input_data = list(d.get("copy_input_data", ()))
        t.copy_output_data = list(d.get("copy_output_data", ()))
        t.tags = dict(d.get("tags", {}))
        t.backend = d.get("backend")
        t.parent_stage = d.get("parent_stage")
        t.parent_pipeline = d.get("parent_pipeline")
        t.submitted_at = None
        t.completed_at = None
        t.ns = d.get("ns") or d.get("tags", {}).get("_wf_ns")
        return t

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Task {self.uid} [{self.state}] {self.executable}>"


# --------------------------------------------------------------------------- #
# Stage
# --------------------------------------------------------------------------- #

class Stage:
    """A set of mutually independent tasks, executed concurrently.

    Stage closure is O(1) per task completion: when the stage is scheduled
    the WFProcessor arms ``begin_execution`` with the number of tasks still
    expected to reach a final state, and every final completion decrements
    that counter via ``note_task_final``. The counters are only ever touched
    under the WFProcessor's lock, so they are plain ints.
    """

    __slots__ = ("uid", "name", "tasks", "state", "state_history",
                 "post_exec", "parent_pipeline", "ns", "_pending", "_nfailed")

    def __init__(self, name: str = "",
                 post_exec: Optional[Callable[["Stage", "Pipeline"], None]] = None
                 ) -> None:
        self.uid = uid.generate("stage")
        self.name = name or self.uid
        self.tasks: List[Task] = []
        self.state = states.STAGE_INITIAL
        self.state_history: List[Dict[str, Any]] = [
            {"state": self.state, "t": time.time()}
        ]
        # Adaptivity hook: called by the WFProcessor when the stage reaches a
        # final state, with (stage, pipeline); may append stages to the
        # pipeline (the paper's branching-as-decision-task).
        self.post_exec = post_exec
        self.parent_pipeline: Optional[str] = None
        self.ns: Optional[str] = None   # workflow namespace (see Task.ns)
        self._pending = -1      # armed by begin_execution; -1 = not scheduled
        self._nfailed = 0

    def add_tasks(self, tasks: Any) -> None:
        if isinstance(tasks, Task):
            tasks = [tasks]
        for t in tasks:
            if not isinstance(t, Task):
                raise TypeError_(f"Stage.add_tasks expects Task, got {type(t)}")
            t.parent_stage = self.uid
            # tasks may be added after the stage already joined a pipeline
            if self.parent_pipeline is not None:
                t.parent_pipeline = self.parent_pipeline
            self.tasks.append(t)

    def advance(self, to_state: str) -> None:
        states.validate_transition("stage", self.uid, self.state, to_state)
        self.state = to_state
        self.state_history.append({"state": to_state, "t": time.time()})

    @property
    def is_final(self) -> bool:
        return self.state in states.STAGE_FINAL

    # -- O(1) closure accounting -------------------------------------------- #

    def begin_execution(self, pending: int) -> None:
        """Arm the completion countdown: ``pending`` tasks still owe a final
        state (retries keep a task pending; resumed tasks never count)."""
        self._pending = pending

    def note_task_final(self, failed: bool) -> None:
        """Record one task reaching a *terminal* final state (no retry left)."""
        if self._pending > 0:
            self._pending -= 1
        if failed:
            self._nfailed += 1

    @property
    def pending_tasks(self) -> int:
        """Tasks still expected to complete; -1 until the stage is scheduled."""
        return self._pending

    @property
    def failed_tasks(self) -> int:
        return self._nfailed

    def to_dict(self) -> Dict[str, Any]:
        return {
            "uid": self.uid,
            "name": self.name,
            "state": self.state,
            "parent_pipeline": self.parent_pipeline,
            "tasks": [t.to_dict() for t in self.tasks],
        }

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Stage {self.uid} [{self.state}] ntasks={len(self.tasks)}>"


# --------------------------------------------------------------------------- #
# Pipeline
# --------------------------------------------------------------------------- #

class Pipeline:
    """An ordered list of stages. Stage *i* starts only after *i-1* is final."""

    __slots__ = ("uid", "name", "stages", "state", "state_history",
                 "_cursor", "lock", "ns", "_nfailed", "_append_listener")

    def __init__(self, name: str = "") -> None:
        self.uid = uid.generate("pipeline")
        self.name = name or self.uid
        self.stages: List[Stage] = []
        self.state = states.PIPELINE_INITIAL
        self.state_history: List[Dict[str, Any]] = [
            {"state": self.state, "t": time.time()}
        ]
        self._cursor = 0          # index of the next stage to schedule
        self.ns: Optional[str] = None   # workflow namespace (see Task.ns)
        # Adaptive post_exec callbacks append stages concurrently with the
        # WFProcessor reading them; both sides take this lock.
        self.lock = threading.RLock()
        self._nfailed = 0         # terminally-failed tasks, pipeline-wide
        # Dirty-notification hook: the WFProcessor registers a callback so
        # stages appended at runtime (post_exec adaptivity, or any other
        # thread) mark this pipeline dirty instead of relying on a poll.
        self._append_listener: Optional[Callable[[str], None]] = None

    def set_append_listener(self,
                            cb: Optional[Callable[[str], None]]) -> None:
        """Register ``cb(pipeline_uid)`` to fire whenever stages are added."""
        self._append_listener = cb

    def add_stages(self, stage_or_stages: Any) -> None:
        if isinstance(stage_or_stages, Stage):
            stage_or_stages = [stage_or_stages]
        with self.lock:
            for s in stage_or_stages:
                if not isinstance(s, Stage):
                    raise TypeError_(
                        f"Pipeline.add_stages expects Stage, got {type(s)}")
                s.parent_pipeline = self.uid
                for t in s.tasks:
                    t.parent_pipeline = self.uid
                self.stages.append(s)
            listener = self._append_listener
        if listener is not None:
            listener(self.uid)

    def advance(self, to_state: str) -> None:
        states.validate_transition("pipeline", self.uid, self.state, to_state)
        self.state = to_state
        self.state_history.append({"state": to_state, "t": time.time()})

    # -- scheduling cursor --------------------------------------------------#

    def next_stage(self) -> Optional[Stage]:
        """Return the next schedulable stage, or None if exhausted/blocked."""
        with self.lock:
            if self._cursor >= len(self.stages):
                return None
            stage = self.stages[self._cursor]
            if stage.state == states.STAGE_INITIAL:
                return stage
            if stage.is_final:
                # cursor catch-up (stage finished; point at the following one)
                self._cursor += 1
                return self.next_stage()
            return None  # current stage still executing

    def mark_stage_final(self, stage_uid: str) -> None:
        with self.lock:
            if (self._cursor < len(self.stages)
                    and self.stages[self._cursor].uid == stage_uid):
                self._cursor += 1

    @property
    def completed(self) -> bool:
        with self.lock:
            return self._cursor >= len(self.stages)

    @property
    def is_final(self) -> bool:
        return self.state in states.PIPELINE_FINAL

    # -- O(1) closure accounting -------------------------------------------- #

    def note_task_failed(self) -> None:
        """Record one terminally-failed task (WFProcessor-lock protected)."""
        self._nfailed += 1

    @property
    def failed_tasks(self) -> int:
        return self._nfailed

    @property
    def ntasks(self) -> int:
        with self.lock:
            return sum(len(s.tasks) for s in self.stages)

    def to_dict(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "uid": self.uid,
                "name": self.name,
                "state": self.state,
                "cursor": self._cursor,
                "stages": [s.to_dict() for s in self.stages],
            }

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<Pipeline {self.uid} [{self.state}] "
                f"nstages={len(self.stages)} cursor={self._cursor}>")


# --------------------------------------------------------------------------- #
# WorkflowIndex
# --------------------------------------------------------------------------- #

class WorkflowIndex:
    """O(1) uid → object routing tables for a live workflow.

    Replaces the bare ``task_index`` dict and the WFProcessor's linear
    ``_find_pipeline``/``_find_stage`` scans: a completion event resolves
    task → Stage object → Pipeline object in three dict lookups, so per-task
    completion routing is independent of the number of pipelines/stages
    (the paper's O(10⁴)-task scalability requirement).

    Stages appended at runtime by adaptive ``post_exec`` hooks are registered
    through :meth:`add_stage` when the WFProcessor first schedules them.
    """

    __slots__ = ("_tasks", "_stages", "_pipelines", "_lock")

    def __init__(self) -> None:
        self._tasks: Dict[str, Task] = {}
        self._stages: Dict[str, Stage] = {}
        self._pipelines: Dict[str, Pipeline] = {}
        self._lock = threading.RLock()

    # -- registration ------------------------------------------------------- #

    def add_pipeline(self, pipe: Pipeline) -> None:
        with self._lock:
            self._pipelines[pipe.uid] = pipe
            with pipe.lock:
                for stage in pipe.stages:
                    self._stages[stage.uid] = stage
                    for task in stage.tasks:
                        self._tasks[task.uid] = task

    def add_stage(self, stage: Stage) -> None:
        with self._lock:
            self._stages[stage.uid] = stage
            for task in stage.tasks:
                self._tasks[task.uid] = task

    def add_task(self, task: Task) -> None:
        with self._lock:
            self._tasks[task.uid] = task

    # -- O(1) lookups ------------------------------------------------------- #

    def task(self, uid: str) -> Optional[Task]:
        return self._tasks.get(uid)

    def stage(self, uid: str) -> Optional[Stage]:
        return self._stages.get(uid)

    def pipeline(self, uid: str) -> Optional[Pipeline]:
        return self._pipelines.get(uid)

    def stage_of(self, task: Task) -> Optional[Stage]:
        if task.parent_stage is None:
            return None
        return self._stages.get(task.parent_stage)

    def pipeline_of(self, task: Task) -> Optional[Pipeline]:
        if task.parent_pipeline is None:
            return None
        return self._pipelines.get(task.parent_pipeline)

    def route(self, uid: str
              ) -> "tuple[Optional[Task], Optional[Stage], Optional[Pipeline]]":
        """Resolve a completion uid to its (task, stage, pipeline) triple."""
        task = self._tasks.get(uid)
        if task is None:
            return None, None, None
        return task, self.stage_of(task), self.pipeline_of(task)

    # -- introspection ------------------------------------------------------ #

    @property
    def ntasks(self) -> int:
        return len(self._tasks)

    @property
    def nstages(self) -> int:
        return len(self._stages)

    @property
    def npipelines(self) -> int:
        return len(self._pipelines)

    def __len__(self) -> int:
        return len(self._tasks)
