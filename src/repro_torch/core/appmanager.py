"""AppManager: the master component of the toolkit (paper §II-B.2/3).

Responsibilities, mirroring the paper:

* holds the application description and the authoritative state table,
* creates all queues, spawns the Synchronizer, instantiates WFProcessor and
  ExecManager,
* supervises component threads (restarting any that die — failure model),
* supervises the RTS through the ExecManager heartbeat (restart + resubmit),
* journals every transition so a full toolkit failure can resume "up to the
  latest successful transaction" (``resume=True`` skips completed tasks by
  name),
* exposes the overhead decomposition the paper measures (setup / management /
  tear-down / RTS / staging / execution).

Beyond the paper (framework requirements at 10³+ nodes): elastic pilot
resizing, straggler speculation (see ExecManager), pluggable RTS factories.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Union

from .. import telemetry as tel
from . import states as st
from .broker import Broker
from .exceptions import EnTKError, ValueError_
from .journal import Journal
from .policies import RetryPolicy
from .profiler import (ENTK_SETUP, ENTK_TEARDOWN, Profiler)
from .pst import Pipeline, WorkflowIndex
from .execmanager import ExecManager
from .state_service import StateService
from .synchronizer import Synchronizer
from .wfprocessor import WFProcessor
from ..rts.base import RTS, ResourceDescription
from ..rts.federation import FederatedRTS, MemberSpec
from ..rts.local import LocalRTS


class AppManager:
    """Programmatic entry point.

    Typical use::

        amgr = AppManager(resources=ResourceDescription(slots=8))
        amgr.workflow = [pipeline1, pipeline2]
        amgr.run()

    ``rts_factory`` defaults to :class:`LocalRTS`. ``journal_path`` enables
    durable transactions and resume.

    **Multi-resource (federated) runs**: pass a *list* of resource
    descriptions — one per pilot — and, optionally, a matching list of RTS
    factories (a single factory is reused for every member). The AppManager
    then drives a :class:`~repro.rts.federation.FederatedRTS` over the whole
    fleet: one workflow spans every pilot, tasks optionally pin to a member
    through ``Task.backend`` (member names come from
    ``description.extra['name']``, defaulting to ``member<i>``), and a pilot
    that dies mid-run fails over onto the surviving members.
    ``member_restarts`` budgets rebuilding a dead member from its factory.
    """

    def __init__(
        self,
        resources: Optional[Union[ResourceDescription,
                                  List[ResourceDescription]]] = None,
        rts_factory: Optional[Union[Callable[[], RTS],
                                    List[Callable[[], RTS]]]] = None,
        journal_path: Optional[str] = None,
        strict_transactions: bool = False,
        on_task_failure: str = "continue",
        heartbeat_interval: float = 0.5,
        max_rts_restarts: int = 3,
        straggler_factor: float = 0.0,
        straggler_min_seconds: float = 1.0,
        speculation_min_samples: int = 64,
        retry_policy: Optional["RetryPolicy"] = None,
        component_supervision: bool = True,
        flush_every: int = 32,
        fsync_critical: bool = True,
        member_restarts: int = 0,
    ) -> None:
        if isinstance(resources, (list, tuple)):
            specs = self._member_specs(list(resources), rts_factory)
            self.resources = ResourceDescription(
                slots=sum(rd.slots for rd in resources),
                platform="federated")
            self.rts_factory = lambda: FederatedRTS(
                specs, heartbeat_interval=heartbeat_interval,
                member_restarts=member_restarts)
        else:
            if isinstance(rts_factory, (list, tuple)):
                raise ValueError_(
                    "a list of rts factories requires a matching list of "
                    "resource descriptions")
            rd = resources or ResourceDescription(slots=4)
            # own copy: the toolkit records granted-not-requested capacity
            # into its description (acquire/resize), and that bookkeeping
            # must never write through into the caller's object
            self.resources = dataclasses.replace(rd, extra=dict(rd.extra))
            self.rts_factory = rts_factory or LocalRTS
        self.journal_path = journal_path
        self.strict_transactions = strict_transactions
        self.on_task_failure = on_task_failure
        self.heartbeat_interval = heartbeat_interval
        self.max_rts_restarts = max_rts_restarts
        self.straggler_factor = straggler_factor
        self.straggler_min_seconds = straggler_min_seconds
        self.speculation_min_samples = speculation_min_samples
        self.retry_policy = retry_policy
        self.component_supervision = component_supervision
        self.flush_every = flush_every
        self.fsync_critical = fsync_critical

        self._workflow: List[Pipeline] = []
        self.prof = Profiler()
        self.state_table: Dict[str, str] = {}
        # O(1) uid -> object routing shared by WFProcessor and ExecManager
        # (replaces the bare task_index dict + linear pipeline/stage scans)
        self.index = WorkflowIndex()

        self.broker: Optional[Broker] = None
        self.journal: Optional[Journal] = None
        self.svc: Optional[StateService] = None
        self.sync: Optional[Synchronizer] = None
        self.wfp: Optional[WFProcessor] = None
        self.emgr: Optional[ExecManager] = None
        self._supervisor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.component_restarts = 0
        self._terminated = False

    @staticmethod
    def _member_specs(
        rds: List[ResourceDescription],
        rts_factory: Optional[Union[Callable[[], RTS],
                                    List[Callable[[], RTS]]]],
    ) -> List[MemberSpec]:
        if not rds:
            raise ValueError_("multi-resource run requires >= 1 description")
        if isinstance(rts_factory, (list, tuple)):
            factories = list(rts_factory)
            if len(factories) != len(rds):
                raise ValueError_(
                    f"{len(rds)} resource descriptions but "
                    f"{len(factories)} rts factories")
        else:
            factories = [rts_factory or LocalRTS] * len(rds)
        specs = []
        for i, (rd, factory) in enumerate(zip(rds, factories)):
            name = str(rd.extra.get("name", f"member{i}"))
            specs.append(MemberSpec(name=name, factory=factory, resources=rd))
        names = [s.name for s in specs]
        if len(names) != len(set(names)):
            # fail fast at construction — the FederatedRTS factory would
            # only surface this at resource-acquisition time
            raise ValueError_(f"duplicate federation member names: {names}")
        return specs

    # -- workflow handling -----------------------------------------------------#

    @property
    def workflow(self) -> List[Pipeline]:
        return self._workflow

    @workflow.setter
    def workflow(self, value) -> None:
        """Assign the application description, validating it *now*.

        Mis-described workflows used to surface deep inside the run (a
        non-Pipeline entry crashed the Enqueue thread; duplicate names broke
        resume keying and the declarative result store silently). Accepts a
        single Pipeline, a list of Pipelines, or anything iterable over
        Pipelines (e.g. an ``api.compile()`` result).
        """
        if isinstance(value, Pipeline):
            value = [value]
        pipelines = list(value)
        for entry in pipelines:
            if not isinstance(entry, Pipeline):
                raise ValueError_(
                    f"workflow entries must be Pipeline, got "
                    f"{type(entry).__name__}: {entry!r} — wrap Stages/Tasks "
                    f"in a Pipeline (or use repro.api and compile())")
        pnames = [p.name for p in pipelines]
        if len(pnames) != len(set(pnames)):
            dupes = sorted({n for n in pnames if pnames.count(n) > 1})
            raise ValueError_(
                f"duplicate pipeline names in workflow: {dupes} — pipeline "
                f"names must be unique (they key journal replay and the "
                f"state table)")
        tnames = [t.name for p in pipelines for s in p.stages
                  for t in s.tasks]
        if len(tnames) != len(set(tnames)):
            seen, dupes = set(), set()
            for n in tnames:
                (dupes if n in seen else seen).add(n)
            raise ValueError_(
                f"duplicate task names in workflow: {sorted(dupes)[:5]} — "
                f"task names must be unique across the workflow (resume and "
                f"result routing are keyed on them)")
        self._workflow = pipelines

    def _validate(self, resume: bool) -> None:
        if not self.workflow:
            raise ValueError_("workflow is empty")
        names = [t.name for p in self.workflow for s in p.stages
                 for t in s.tasks]
        if (resume or self.journal_path) and len(names) != len(set(names)):
            raise ValueError_(
                "resumable workflows require unique task names")
        for p in self.workflow:
            if not p.stages:
                raise ValueError_(f"pipeline {p.uid} has no stages")
            for s in p.stages:
                if not s.tasks:
                    raise ValueError_(f"stage {s.uid} has no tasks")

    def _index_tasks(self) -> None:
        for p in self.workflow:
            self.index.add_pipeline(p)

    # -- main entry -------------------------------------------------------------#

    def run(self, resume: bool = False, timeout: float = 3600.0) -> Dict[str, float]:
        """Execute the workflow to completion; returns the overhead report.

        ``resume=True`` replays the journal at ``journal_path`` and skips
        tasks whose last journaled state was DONE.
        """
        # ---- setup (profiled: EnTK Setup Overhead) --------------------------- #
        self.prof.begin(ENTK_SETUP)
        setup_span = tel.span("appmanager.setup", "am",
                              pipelines=len(self.workflow), resume=resume)
        self._validate(resume)
        resumed_done = set()
        resumed_retries: Dict[str, int] = {}
        resumed_results: Dict[str, object] = {}
        result_omitted: set = set()
        if resume and self.journal_path and os.path.exists(self.journal_path):
            replay = Journal.replay(self.journal_path)
            for (kind, name), state in replay["state"].items():
                if kind == "task" and state == st.DONE:
                    resumed_done.add(name)
            resumed_retries = dict(replay["retries"])
            resumed_results = dict(replay["results"])
            result_omitted = set(replay["result_omitted"])
        self._index_tasks()
        for p in self.workflow:
            for s in p.stages:
                for t in s.tasks:
                    if t.name in resumed_retries:
                        t.retries = min(t.max_retries,
                                        resumed_retries[t.name])
        self.broker = Broker()
        self.journal = Journal(self.journal_path,
                               flush_every=self.flush_every,
                               fsync_critical=self.fsync_critical)
        self.journal.session("resume" if resume else "start",
                             pipelines=len(self.workflow))
        self.svc = StateService(self.broker, strict=self.strict_transactions,
                                durable=self.journal.enabled)
        self.sync = Synchronizer(self.broker, self.journal, self.state_table)
        self.sync.start()
        self.wfp = WFProcessor(
            self.broker, self.svc, self.prof, self.workflow, self.index,
            on_task_failure=self.on_task_failure, resumed_done=resumed_done,
            # results restore at scheduling time (covers stages appended at
            # runtime by adaptive rounds, not just the static prefix)
            resumed_results=resumed_results, result_omitted=result_omitted,
            # sidecar for results that journal as spill records (fused
            # device arrays) — only meaningful with a write-ahead journal
            spill_dir=(f"{self.journal_path}.spill"
                       if self.journal_path else None),
            retry_policy=self.retry_policy)
        self.emgr = ExecManager(
            self.broker, self.svc, self.prof, self.rts_factory,
            self.resources, self.index,
            heartbeat_interval=self.heartbeat_interval,
            max_rts_restarts=self.max_rts_restarts,
            straggler_factor=self.straggler_factor,
            straggler_min_seconds=self.straggler_min_seconds,
            speculation_min_samples=self.speculation_min_samples)
        setup_span.end()
        self.prof.end(ENTK_SETUP)

        # ---- resources + execution ---------------------------------------- #
        self.emgr.acquire_resources()
        # superstage scheduling is only sound against an RTS that composes
        # chains itself (it receives downstream links before their inputs
        # are routed and orders them internally); everywhere else stage
        # ordering keeps gating submissions
        chain_ok = getattr(self.emgr.rts, "supports_chain_fusion", None)
        try:
            self.wfp.chain_scheduling = bool(chain_ok and chain_ok())
        except Exception:  # noqa: BLE001 - a dying RTS answers like "no"
            self.wfp.chain_scheduling = False
        self.wfp.start()
        self.emgr.start()
        if self.component_supervision:
            self._stop.clear()
            self._supervisor = threading.Thread(
                target=self._supervise, daemon=True, name="am-supervisor")
            self._supervisor.start()

        try:
            deadline = time.monotonic() + timeout
            # event-driven wait: the WFProcessor sets done_event when the
            # last pipeline finalizes; the short timeout only bounds how
            # quickly errors/timeout are noticed, it does no scheduling work
            while not self.wfp.done_event.wait(timeout=0.05):
                if time.monotonic() > deadline:
                    raise EnTKError(f"workflow timed out after {timeout}s")
                if (self.emgr.component_errors
                        and "restart budget exhausted"
                        in self.emgr.component_errors[-1]):
                    raise EnTKError("RTS restart budget exhausted")
        finally:
            self._terminate()
        return self.prof.totals()

    # -- serving mode (persistent multi-tenant daemon) -----------------------#

    def start_service(self, journal: Optional[Journal] = None) -> None:
        """Bring up the full component stack with no workflow attached.

        The serving layer (``repro.serve``) submits workflows afterwards
        through :meth:`submit_pipelines`; the components drain-and-wait
        instead of drain-and-exit. ``journal`` accepts a Journal-compatible
        router (the service's :class:`~repro.serve.journal.TenantJournals`)
        so transitions land in per-tenant write-ahead files.
        """
        if self.broker is not None:
            raise EnTKError("service already started")
        self.prof.begin(ENTK_SETUP)
        setup_span = tel.span("appmanager.setup", "am", service=True)
        self.broker = Broker()
        self.journal = (journal if journal is not None
                        else Journal(self.journal_path,
                                     flush_every=self.flush_every,
                                     fsync_critical=self.fsync_critical))
        self.journal.session("start", service=True)
        self.svc = StateService(self.broker, strict=self.strict_transactions,
                                durable=self.journal.enabled)
        self.sync = Synchronizer(self.broker, self.journal, self.state_table)
        self.sync.start()
        self.wfp = WFProcessor(
            self.broker, self.svc, self.prof, self._workflow, self.index,
            on_task_failure=self.on_task_failure,
            spill_dir=(f"{self.journal_path}.spill"
                       if self.journal_path else None),
            retry_policy=self.retry_policy)
        self.emgr = ExecManager(
            self.broker, self.svc, self.prof, self.rts_factory,
            self.resources, self.index,
            heartbeat_interval=self.heartbeat_interval,
            max_rts_restarts=self.max_rts_restarts,
            straggler_factor=self.straggler_factor,
            straggler_min_seconds=self.straggler_min_seconds,
            speculation_min_samples=self.speculation_min_samples)
        setup_span.end()
        self.prof.end(ENTK_SETUP)
        self.emgr.acquire_resources()
        chain_ok = getattr(self.emgr.rts, "supports_chain_fusion", None)
        try:
            self.wfp.chain_scheduling = bool(chain_ok and chain_ok())
        except Exception:  # noqa: BLE001 - a dying RTS answers like "no"
            self.wfp.chain_scheduling = False
        self.wfp.start()
        self.emgr.start()
        if self.component_supervision:
            self._stop.clear()
            self._supervisor = threading.Thread(
                target=self._supervise, daemon=True, name="am-supervisor")
            self._supervisor.start()

    def submit_pipelines(
        self,
        pipelines: List[Pipeline],
        ns: Optional[str] = None,
        resumed_done: Optional[set] = None,
        resumed_results: Optional[Dict[str, object]] = None,
        result_omitted: Optional[set] = None,
        resumed_retries: Optional[Dict[str, int]] = None,
        spill_dir: Optional[str] = None,
    ) -> None:
        """Admit a workflow into the running service.

        Bypasses the ``workflow`` setter's cross-workflow task-name
        uniqueness check deliberately: each submission's names are unique
        within its own compile namespace (``_Ctx.claim``) and all routing —
        results, journals, resume — is keyed ``(namespace, name)``.
        """
        if self.wfp is None:
            raise EnTKError("start_service() before submit_pipelines()")
        for entry in pipelines:
            if not isinstance(entry, Pipeline):
                raise ValueError_(
                    f"submit_pipelines expects Pipeline, got "
                    f"{type(entry).__name__}")
        if resumed_retries:
            for p in pipelines:
                for s in p.stages:
                    for t in s.tasks:
                        if t.name in resumed_retries:
                            t.retries = min(t.max_retries,
                                            resumed_retries[t.name])
        if ns is not None and (resumed_done or resumed_results
                               or result_omitted or spill_dir):
            self.wfp.add_resumed_namespace(
                ns, resumed_done or set(), resumed_results or {},
                result_omitted or set(), spill_dir=spill_dir)
        for p in pipelines:
            self.index.add_pipeline(p)
        self._workflow.extend(pipelines)
        self.wfp.add_pipelines(pipelines)

    def cancel_pipelines(self, pipelines: List[Pipeline]) -> None:
        """Cancel one submission's pipelines without touching the others.

        Mirrors :meth:`cancel`'s locking, then finalizes each pipeline to
        CANCELED itself (the RTS drops queued/held members without emitting
        completions, so the normal closure chain would never fire)."""
        import contextlib

        uids = [t.uid for p in pipelines for s in p.stages for t in s.tasks
                if not t.is_final]
        if self.emgr is not None and self.emgr.rts is not None and uids:
            self.emgr.rts.cancel(uids)
        emgr_lock = (self.emgr._lock if self.emgr is not None
                     else contextlib.nullcontext())
        for p in pipelines:
            canceled_now = False
            with p.lock, emgr_lock:
                if p.is_final:
                    continue
                for s in p.stages:
                    for t in s.tasks:
                        if not t.is_final and self.svc is not None:
                            try:
                                self.svc.advance(t, st.CANCELED)
                            except Exception:  # noqa: BLE001
                                pass
                    if not s.is_final and self.svc is not None:
                        try:
                            self.svc.advance(s, st.STAGE_CANCELED)
                        except Exception:  # noqa: BLE001
                            pass
                if self.svc is not None:
                    try:
                        self.svc.advance(p, st.PIPELINE_CANCELED)
                        canceled_now = True
                    except Exception:  # noqa: BLE001
                        pass
            if canceled_now and self.wfp is not None:
                self.wfp.note_pipeline_closed(p)
        if self.emgr is not None and uids:
            # canceled members the RTS dropped without a completion (queued
            # or parked in a batching hold) would otherwise stay in Emgr
            # custody forever and block its quiescence accounting; a member
            # actually mid-execution still completes, and its late callback
            # is a harmless duplicate after this purge
            with self.emgr._lock:
                for u in uids:
                    self.emgr._submitted.pop(u, None)

    def stop_service(self) -> Dict[str, float]:
        """Tear the service down; returns the overhead report."""
        self._terminate()
        return self.prof.totals()

    def cancel(self) -> None:
        """Cancel all outstanding work and finalize.

        Takes each pipeline's lock (serializing against the WFProcessor's
        completion chains) AND the ExecManager's lock (serializing against
        the submission chain, which runs outside pipeline locks) so the
        CANCELED transition can neither interleave with nor be overwritten
        by a concurrent multi-hop advance on the same task."""
        import contextlib

        if self.emgr is not None and self.emgr.rts is not None:
            self.emgr.rts.cancel(self.emgr.rts.in_flight())
        emgr_lock = (self.emgr._lock if self.emgr is not None
                     else contextlib.nullcontext())
        for p in self.workflow:
            with p.lock, emgr_lock:
                for s in p.stages:
                    for t in s.tasks:
                        if not t.is_final and self.svc is not None:
                            try:
                                self.svc.advance(t, st.CANCELED)
                            except Exception:  # noqa: BLE001
                                pass

    # -- teardown ------------------------------------------------------------#

    def _terminate(self) -> None:
        if self._terminated:
            return
        self._terminated = True
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=2.0)
        # RTS teardown is profiled separately inside ExecManager.stop
        if self.emgr is not None:
            self.emgr.stop()
        self.prof.begin(ENTK_TEARDOWN)
        with tel.span("appmanager.teardown", "am"):
            if self.wfp is not None:
                self.wfp.stop()
            if self.sync is not None:
                self.sync.stop()
            if self.journal is not None:
                self.journal.session("end")
                self.journal.close()
            if self.broker is not None:
                self.broker.close()
        if self.journal_path and tel.enabled():
            # journal-adjacent metrics snapshot: <journal>.telemetry.jsonl
            # lands next to the WAL so a postmortem reads both side by side
            try:
                tel.export_jsonl(f"{self.journal_path}.telemetry.jsonl")
            except OSError:
                pass
        self.prof.end(ENTK_TEARDOWN)

    # -- component supervision ---------------------------------------------------#

    def _supervise(self) -> None:
        """Restart dead component threads (EnTK-component failure model)."""
        while not self._stop.is_set():
            # interruptible wait: _terminate must not block on a sleeping
            # supervisor for a join-timeout at every shutdown
            self._stop.wait(self.heartbeat_interval)
            if self._stop.is_set():
                return
            try:
                if self.sync is not None and not self.sync.is_alive():
                    self.sync.crash_hook = None
                    self.broker.requeue_unacked("states")
                    self.sync.start()
                    self.component_restarts += 1
                if self.wfp is not None:
                    alive = self.wfp.threads_alive()
                    if not alive["enqueue"]:
                        self.wfp.enqueue_crash_hook = None
                        self.broker.requeue_unacked("schedule")
                        self.wfp.start_enqueue()
                        self.component_restarts += 1
                    if not alive["dequeue"]:
                        self.wfp.dequeue_crash_hook = None
                        self.broker.requeue_unacked("done")
                        self.wfp.start_dequeue()
                        self.component_restarts += 1
                if self.emgr is not None:
                    ealive = self.emgr.threads_alive()
                    if not ealive["emgr"]:
                        self.emgr.emgr_crash_hook = None
                        self.broker.requeue_unacked("pending")
                        self.emgr.start_emgr()
                        self.component_restarts += 1
                    if not ealive["heartbeat"]:
                        self.emgr.start_heartbeat()
                        self.component_restarts += 1
                    if not ealive.get("watchdog", True):
                        self.emgr.start_watchdog()
                        self.component_restarts += 1
            except Exception:  # noqa: BLE001 - supervisor must survive anything
                pass

    # -- convenience ------------------------------------------------------------#

    def states_of(self, names: List[str]) -> Dict[str, str]:
        return {n: self.state_table.get(f"task:{n}", "UNKNOWN") for n in names}

    @property
    def all_done(self) -> bool:
        return all(
            t.state == st.DONE
            for p in self.workflow for s in p.stages for t in s.tasks)
