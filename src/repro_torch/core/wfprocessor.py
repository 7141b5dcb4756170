"""WFProcessor: the workflow-management component (paper §II-B.2/3).

Two subcomponents, each a restartable thread, both **event-driven** (no
sleep-polling anywhere on the hot path):

* **Enqueue** — blocks on the ``schedule`` queue of *dirty pipeline* uids.
  A pipeline is marked dirty when it first enters the workflow, when one of
  its stages closes, or when an adaptive ``post_exec`` hook appends stages
  at runtime (the Pipeline's append listener fires on ``add_stages``). Each
  wakeup schedules exactly the pipelines that changed — per-event cost is
  O(changed pipelines), not O(all pipelines).
* **Dequeue** — blocks on the ``done`` queue. Each completion routes to its
  (task, stage, pipeline) triple through the :class:`WorkflowIndex` in O(1)
  and closes stages/pipelines through per-stage pending counters in O(1),
  instead of re-scanning ``all(t.is_final ...)`` per event.

Both loops are stateless between iterations: all state lives in the master
PST objects and the queues, which is what makes component restart after a
crash safe (failure model, §II-B.4).
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from .. import telemetry as tel
from . import states as st
from .broker import Broker
from .profiler import (DATA_STAGING, ENTK_MANAGEMENT, TASK_EXECUTION,
                       Profiler)
from .policies import INFRA, RETRY_TOTAL, TASK, RetryPolicy
from .pst import Pipeline, Stage, Task, WorkflowIndex
from .results import STORE as RESULTS
from .results import decode_journal_value, spill_journal_value
from .state_service import StateService

PENDING_QUEUE = "pending"
DONE_QUEUE = "done"
SCHEDULE_QUEUE = "schedule"   # dirty-pipeline notification channel


class WFProcessor:
    """Drives an application (list of pipelines) through the PST semantics."""

    #: Largest JSON-encoded task result (bytes) journaled on DONE records.
    RESULT_JOURNAL_CAP = 256 * 1024

    def __init__(
        self,
        broker: Broker,
        svc: StateService,
        prof: Profiler,
        pipelines: List[Pipeline],
        index: WorkflowIndex,
        on_task_failure: str = "continue",  # or "fail_stage"
        resumed_done: Optional[set] = None,
        resumed_results: Optional[Dict[str, Any]] = None,
        result_omitted: Optional[set] = None,
        spill_dir: Optional[str] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        self.broker = broker
        self.svc = svc
        self.prof = prof
        self.pipelines = pipelines
        self.index = index
        self.on_task_failure = on_task_failure
        self.resumed_done = resumed_done or set()
        # journal-replayed task return values / names whose value could not
        # be journaled; applied at *scheduling* time so stages appended at
        # runtime (adaptive rounds) restore results exactly like static ones
        self.resumed_results = resumed_results or {}
        self.result_omitted = result_omitted or set()
        # sidecar directory for results too rich to JSON onto a DONE record
        # (fused array handles journal a content hash + spill path instead)
        self.spill_dir = spill_dir
        # Unified retry channel (chaos plane): one policy decides budgets
        # and backoff for BOTH fault classes — infra (pilot_lost, uncharged
        # by default) and task (charged against task.max_retries). The
        # default policy reproduces the historical behaviour exactly.
        self.retry_policy = retry_policy or RetryPolicy()
        self._infra_retries: Dict[str, int] = {}     # uid -> uncharged hops
        self._first_failure: Dict[str, float] = {}   # uid -> monotonic t0
        self._retry_timers: List[threading.Timer] = []
        self.backoff_requeues = 0
        # Superstage scheduling (chain fusion): when the RTS composes
        # ``_fusion_chain``-tagged stages (JaxRTS.supports_chain_fusion),
        # a chain's downstream stages are handed off TOGETHER with its
        # entry stage so the RTS can run the whole chain on one lease —
        # the control plane stops sitting between the links. Off (the
        # default), stage ordering gates submissions exactly as before;
        # the AppManager flips it per run after acquiring resources.
        self.chain_scheduling = False
        broker.declare(PENDING_QUEUE)
        broker.declare(DONE_QUEUE)
        broker.declare(SCHEDULE_QUEUE)
        self._stop = threading.Event()
        self._enqueue_thread: Optional[threading.Thread] = None
        self._dequeue_thread: Optional[threading.Thread] = None
        # fallback for completions that cannot be routed to a pipeline
        # (scheduling/closure otherwise lock per-pipeline) + closure counting
        self._lock = threading.RLock()
        self.enqueue_crash_hook: Optional[Callable[[], None]] = None
        self.dequeue_crash_hook: Optional[Callable[[], None]] = None
        self.component_errors: List[str] = []
        # Event-driven completion signal: the AppManager waits on this
        # instead of polling workflow_final.
        self.done_event = threading.Event()
        self._open_pipelines = len(pipelines)
        # Serving mode (multi-tenant daemon): pipelines may be added while
        # the loops run (`add_pipelines`), per-workflow resume state is
        # registered per namespace (`add_resumed_namespace`), and every
        # pipeline closure is reported through this hook so submission
        # handles can complete individually — done_event then only means
        # "idle right now", not "drained forever".
        self.on_pipeline_final: Optional[Callable[[Pipeline], None]] = None
        self._ns_resume: Dict[str, tuple] = {}
        self._ns_spill: Dict[str, str] = {}

    # -- lifecycle ----------------------------------------------------------#

    def start(self) -> None:
        self._stop.clear()
        for pipe in self.pipelines:
            pipe.set_append_listener(self._mark_dirty)
        self.start_enqueue()
        self.start_dequeue()
        # Seed the ready set: every pipeline is dirty until first scheduled
        # (one queue operation, not one per pipeline).
        self.broker.put_many(SCHEDULE_QUEUE,
                             [pipe.uid for pipe in self.pipelines])

    def start_enqueue(self) -> None:
        self._enqueue_thread = threading.Thread(
            target=self._guarded, args=(self._enqueue_loop, "enqueue"),
            daemon=True, name="wfp-enqueue")
        self._enqueue_thread.start()

    def start_dequeue(self) -> None:
        self._dequeue_thread = threading.Thread(
            target=self._guarded, args=(self._dequeue_loop, "dequeue"),
            daemon=True, name="wfp-dequeue")
        self._dequeue_thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            timers, self._retry_timers = self._retry_timers, []
        for timer in timers:
            timer.cancel()
        self.broker.kick(SCHEDULE_QUEUE)
        self.broker.kick(DONE_QUEUE)
        for t in (self._enqueue_thread, self._dequeue_thread):
            if t is not None:
                t.join(timeout=5.0)
        self._enqueue_thread = None
        self._dequeue_thread = None

    # -- serving mode (multi-tenant daemon) ----------------------------------#

    def add_pipelines(self, pipelines: List[Pipeline]) -> None:
        """Admit pipelines into a *running* processor (serving mode).

        The caller must have registered them in the WorkflowIndex first
        (``index.add_pipeline``) so Dequeue can route their completions the
        instant they are visible on the schedule queue.
        """
        with self._lock:
            self.pipelines.extend(pipelines)
            self._open_pipelines += len(pipelines)
            self.done_event.clear()
        for pipe in pipelines:
            pipe.set_append_listener(self._mark_dirty)
        self.broker.put_many(SCHEDULE_QUEUE, [p.uid for p in pipelines])

    def add_resumed_namespace(self, ns: str, done: set,
                              results: Dict[str, Any], omitted: set,
                              spill_dir: Optional[str] = None) -> None:
        """Register journal-replayed resume state scoped to one workflow
        namespace: a resubmitted tenant workflow restores only ITS OWN
        completed tasks even when task names collide across tenants."""
        with self._lock:
            self._ns_resume[ns] = (done, results, omitted)
            if spill_dir is not None:
                self._ns_spill[ns] = spill_dir

    def _resume_for(self, task: Task) -> tuple:
        """(done, results, omitted) governing ``task``'s resume: the
        namespace-scoped set when its workflow registered one, else the
        run-wide replay the classic single-workflow path installs."""
        ns = task.tags.get("_wf_ns")
        if ns is not None and ns in self._ns_resume:
            return self._ns_resume[ns]
        return self.resumed_done, self.resumed_results, self.result_omitted

    def _spill_dir_for(self, task: Task) -> Optional[str]:
        ns = task.tags.get("_wf_ns")
        if ns is not None and ns in self._ns_spill:
            return self._ns_spill[ns]
        return self.spill_dir

    def note_pipeline_closed(self, pipe: Pipeline) -> None:
        """Account a pipeline finalized OUTSIDE the completion chain (the
        service's cancel path advances it to CANCELED itself): decrement the
        open count and fire the closure hook exactly once."""
        with self._lock:
            self._open_pipelines -= 1
            if self._open_pipelines <= 0:
                self.done_event.set()
        if self.on_pipeline_final is not None:
            try:
                self.on_pipeline_final(pipe)
            except Exception:  # noqa: BLE001 - service hook, never fatal
                self.component_errors.append(
                    f"on_pipeline_final[{pipe.uid}]: "
                    f"{traceback.format_exc(limit=5)}")

    def threads_alive(self) -> Dict[str, bool]:
        return {
            "enqueue": bool(self._enqueue_thread
                            and self._enqueue_thread.is_alive()),
            "dequeue": bool(self._dequeue_thread
                            and self._dequeue_thread.is_alive()),
        }

    def _guarded(self, fn: Callable[[], None], name: str) -> None:
        try:
            fn()
        except Exception:  # noqa: BLE001 - component crash, recorded for restart
            self.component_errors.append(
                f"{name}: {traceback.format_exc(limit=5)}")

    # -- completion condition -------------------------------------------------#

    @property
    def workflow_final(self) -> bool:
        return all(p.is_final for p in self.pipelines)

    # -- dirty-pipeline channel ----------------------------------------------#

    def _mark_dirty(self, pipe_uid: str) -> None:
        """Notify Enqueue that ``pipe_uid`` needs a scheduling visit."""
        self.broker.put(SCHEDULE_QUEUE, pipe_uid)

    # -- Enqueue ------------------------------------------------------------#

    def _enqueue_loop(self) -> None:
        while not self._stop.is_set():
            msgs = self.broker.get_many(SCHEDULE_QUEUE, 256, timeout=None,
                                        abort=self._stop)
            if self._stop.is_set():
                return
            if self.enqueue_crash_hook is not None:
                self.enqueue_crash_hook()
            if not msgs:
                continue  # kicked awake; nothing dirty
            t0 = time.perf_counter()
            seen = set()
            done_tags = []
            sink: List[Any] = []
            pending: List[str] = []
            with tel.span("wfp.enqueue_batch", "wfp", msgs=len(msgs)):
                try:
                    for tag, uid in msgs:
                        # schedule before ack: a crash mid-batch leaves dirty
                        # marks unacked for redelivery; re-visits are
                        # idempotent
                        if uid not in seen:
                            seen.add(uid)
                            pipe = self.index.pipeline(uid)
                            if pipe is not None:
                                self._schedule_pipeline(pipe, sink, pending)
                        done_tags.append(tag)
                finally:
                    self.svc.flush(sink)
                    if pending:
                        # one pending-queue hand-off for the whole dirty batch
                        self.broker.put_many(PENDING_QUEUE, pending)
                    self.broker.ack_many(SCHEDULE_QUEUE, done_tags)
            self.prof.add(ENTK_MANAGEMENT, time.perf_counter() - t0)

    def _schedule_pipeline(self, pipe: Pipeline,
                           sink: Optional[List[Any]] = None,
                           pending: Optional[List[str]] = None) -> None:
        """Visit one dirty pipeline: advance its cursor as far as possible.

        Locking is per-pipeline: Enqueue scheduling pipeline A never
        contends with Dequeue closing a task of pipeline B (a global lock
        here measurably dominated management overhead at O(10⁴) pipelines).
        State publishes defer into ``sink``; ordering toward Dequeue is
        guaranteed because the pending hand-off (which is what makes
        completions for these objects possible at all) happens only after
        the sink is flushed — see the ``finally`` ordering in the enqueue
        loop and in this function's own-buffer path.
        """
        own = sink is None
        if own:
            sink = []
        own_pending: List[str] = [] if pending is None else None
        if own_pending is not None:
            pending = own_pending
        try:
            with pipe.lock:
                if pipe.is_final:
                    return
                if pipe.state == st.PIPELINE_INITIAL:
                    self.svc.advance(pipe, st.PIPELINE_SCHEDULING,
                                     transact=False, sink=sink)
                while True:
                    stage = pipe.next_stage()
                    if stage is None:
                        if pipe.completed and not pipe.is_final:
                            self._finalize_pipeline(pipe, sink=sink)
                        return
                    if stage.state != st.STAGE_INITIAL:
                        return  # current stage still executing
                    self._schedule_stage(pipe, stage, sink, pending)
                    if not stage.is_final:
                        if self.chain_scheduling:
                            # superstage: a fused chain's downstream link
                            # stages ride the same hand-off so the RTS can
                            # compose the whole chain on one device lease
                            self._schedule_chain_successors(
                                pipe, stage, sink, pending)
                        return  # in flight; completions drive progress
                    # stage closed instantly (fully resumed): advance on
        finally:
            if own:
                self.svc.flush(sink)
            if own_pending:
                self.broker.put_many(PENDING_QUEUE, own_pending)

    def _schedule_stage(self, pipe: Pipeline, stage: Stage,
                        sink: Optional[List[Any]] = None,
                        pending: Optional[List[str]] = None) -> None:
        # register here (not only at startup): adaptive post_exec hooks
        # append stages at runtime and their tasks must be resolvable by the
        # ExecManager and Dequeue through the WorkflowIndex
        self.index.add_stage(stage)
        payload = []
        for task in stage.tasks:
            resumed_done, _, _ = self._resume_for(task)
            if (task.name in resumed_done
                    and task.state == st.INITIAL
                    and not self._result_lost(task)
                    and self._restore_resumed(task, sink)):
                continue
            if task.is_final:
                continue
            if task.state == st.INITIAL:
                self.svc.advance_seq(task, (st.SCHEDULING, st.SCHEDULED),
                                     transact=False, sink=sink)
                payload.append(task.uid)
            elif task.state == st.SCHEDULED:
                # crash-recovery re-visit: the task was advanced but the
                # pending hand-off may have been lost — hand it off again
                # (the ExecManager deduplicates against its backlog and
                # custody), and never re-run the SCHEDULING chain
                payload.append(task.uid)
            # other states: already with the ExecManager/RTS
        # Arm the O(1) closure countdown before any completion can race in
        # (we hold pipe.lock; Dequeue takes it before decrementing).
        # Counting non-final tasks (not len(payload)) keeps re-visits exact.
        stage.begin_execution(sum(1 for t in stage.tasks if not t.is_final))
        if payload:
            if pending is not None:
                # deferred hand-off: the caller publishes the whole dirty
                # batch to the pending queue in one operation, after the
                # state sink is flushed
                pending.extend(payload)
            else:
                if sink is not None:
                    # the ExecManager may advance these tasks as soon as
                    # they are visible on the pending queue
                    self.svc.flush(sink)
                self.broker.put_many(PENDING_QUEUE, payload)
        self.svc.advance_seq(stage, (st.STAGE_SCHEDULING, st.STAGE_SCHEDULED),
                             transact=False, sink=sink)
        # A stage whose every task was resumed completes immediately.
        self._maybe_finalize_stage(pipe, stage, sink=sink)

    # -- superstage (chain/DAG fusion) ---------------------------------------#

    #: Task.tags keys stamped by the api compiler's chain/DAG detection
    #: (kept as literals here: the core must not import the fusion package).
    CHAIN_TAG = "_fusion_chain"
    DAG_TAG = "_fusion_dag"

    @classmethod
    def _flow_tag(cls, task) -> Optional[Dict[str, Any]]:
        """The task's chain OR DAG tag — both carry ``c``/``k`` and both
        superstage identically (a DAG is a chain of *nodes*: ensembles and
        fan-in reductions; node indices advance exactly like link
        indices). A task is on at most one flow."""
        tag = task.tags.get(cls.CHAIN_TAG)
        if tag is None:
            tag = task.tags.get(cls.DAG_TAG)
        if (isinstance(tag, dict) and isinstance(tag.get("c"), str)
                and isinstance(tag.get("k"), int)):
            return tag
        return None

    @classmethod
    def _stage_chain_links(cls, stage: Stage) -> Optional[Dict[str, set]]:
        """``{chain/DAG id: {link indices}}`` when EVERY task of the stage
        is a chain link or DAG node member, else None (a mixed stage never
        superstages — its untagged tasks would be submitted ahead of their
        input routing)."""
        sig: Dict[str, set] = {}
        for task in stage.tasks:
            tag = cls._flow_tag(task)
            if tag is None:
                return None
            sig.setdefault(tag["c"], set()).add(tag["k"])
        return sig or None

    def _schedule_chain_successors(self, pipe: Pipeline, stage: Stage,
                                   sink: Optional[List[Any]],
                                   pending: Optional[List[str]]) -> None:
        """Hand off the consecutive stages that continue ``stage``'s chains.

        Stage *i+1* continues stage *i* when every one of its tasks is a
        chain link whose (chain, link) is exactly one past a (chain, link)
        in stage *i*. The whole run lands in ONE pending-queue hand-off
        (the caller's batched ``put_many``), which is what lets the Emgr's
        whole-chain drain and the JaxRTS's chain assembler see complete
        member chains. Called under ``pipe.lock``.
        """
        sig = self._stage_chain_links(stage)
        if not sig:
            return
        try:
            idx = pipe.stages.index(stage)
        except ValueError:  # pragma: no cover - stage always belongs to pipe
            return
        published = [stage]
        for nxt in pipe.stages[idx + 1:]:
            nsig = self._stage_chain_links(nxt)
            if not nsig:
                break
            continues = all(
                c in sig and all(k - 1 in sig[c] for k in links)
                for c, links in nsig.items())
            if not continues:
                break
            if nxt.state == st.STAGE_INITIAL:
                self._schedule_stage(pipe, nxt, sink, pending)
            published.append(nxt)
            sig = nsig
        if len(published) < 2:
            return
        tel.counter("wfp_superstages_total").inc()
        tel.histogram("wfp_superstage_stages").observe(len(published))
        # stamp the superstage EXTENT ("ss" = highest co-published link per
        # chain) onto every published link task: the Emgr only holds a
        # chain fragment for links it knows were co-published — a chain
        # that could not superstage (mixed stage, gated continuation) flows
        # stage by stage with zero hold latency, per-stage fused
        extent: Dict[str, int] = {}
        for s in published:
            for task in s.tasks:
                tag = self._flow_tag(task)
                if tag is not None:
                    extent[tag["c"]] = max(extent.get(tag["c"], 0), tag["k"])
        for s in published:
            for task in s.tasks:
                tag = self._flow_tag(task)
                if tag is not None:
                    tag["ss"] = extent[tag["c"]]

    # -- Dequeue ------------------------------------------------------------#

    def _dequeue_loop(self) -> None:
        while not self._stop.is_set():
            msgs = self.broker.get_many(DONE_QUEUE, 256, timeout=None,
                                        abort=self._stop)
            if self._stop.is_set():
                return
            if self.dequeue_crash_hook is not None:
                self.dequeue_crash_hook()
            if not msgs:
                continue  # kicked awake
            t0 = time.perf_counter()
            done_tags = []
            sink: List[Any] = []
            exec_s = staging_s = 0.0
            n_handled = 0
            span = tel.span("wfp.dequeue_batch", "wfp", msgs=len(msgs))
            try:
                for tag, msg in msgs:
                    # tag first: a message that crashes the handler is acked
                    # (dropped) rather than redelivered into a crash loop
                    done_tags.append(tag)
                    if self._handle_completion(msg, sink):
                        exec_s += float(msg.get("execution_seconds", 0.0))
                        staging_s += float(msg.get("staging_seconds", 0.0))
                        n_handled += 1
            finally:
                self.svc.flush(sink)
                # one lock round for the whole batch; a crash mid-batch
                # leaves only the untouched suffix for redelivery
                self.broker.ack_many(DONE_QUEUE, done_tags)
                span.set(handled=n_handled).end()
            if n_handled:
                # per-batch accumulation: Profiler.add takes a global lock
                self.prof.add(TASK_EXECUTION, exec_s, count=n_handled)
                self.prof.add(DATA_STAGING, staging_s, count=n_handled)
            self.prof.add(ENTK_MANAGEMENT, time.perf_counter() - t0)

    def _handle_completion(self, msg: Dict[str, Any],
                           sink: Optional[List[Any]] = None) -> bool:
        """Process one completion; returns False for filtered duplicates
        (the caller accounts execution/staging time for handled ones)."""
        uid = msg["uid"]
        task, stage, pipe = self.index.route(uid)
        if task is None or task.is_final:
            return False  # duplicate (e.g. the losing speculative attempt)
        task.exit_code = msg.get("exit_code")
        task.exception = msg.get("exception")
        task.result = msg.get("result")
        task.completed_at = msg.get("completed_at")

        with (pipe.lock if pipe is not None else self._lock):
            if task.is_final:
                return False  # canceled under the lock while we waited
            failed = False
            # the RTS callback no longer advances EXECUTED from the RTS's
            # own thread (one less hot-path synchronization point); the
            # completion chain is coalesced into a single published message
            prefix = (st.EXECUTED,) if task.state == st.SUBMITTED else ()
            policy = self.retry_policy
            if msg.get("pilot_lost"):
                # The pilot executing the task died (federation member
                # failover) — an infrastructure failure, not a task failure.
                # Re-journal FAILED (marked ``pilot_lost`` so resume does not
                # charge it against the retry budget) and requeue onto the
                # surviving members: failover must lose zero completions
                # even for max_retries=0 tasks. The infra channel is
                # unbounded by default; a RetryPolicy with
                # ``max_infra_retries`` caps flapping infrastructure.
                exc = str(msg.get("exception", ""))[:500]
                attempts = self._infra_retries.get(task.uid, 0)
                first = self._first_failure.setdefault(
                    task.uid, time.monotonic())
                if policy.should_retry(task, INFRA, attempts, first):
                    self._infra_retries[task.uid] = attempts + 1
                    tel.counter(RETRY_TOTAL, fault_class=INFRA).inc()
                    self.svc.advance_seq(task, prefix + (st.FAILED,), exc=exc,
                                         pilot_lost=True, sink=sink)
                    self.svc.advance_seq(task, (st.SCHEDULING, st.SCHEDULED),
                                         transact=False, sink=sink)
                    if sink is not None:
                        self.svc.flush(sink)  # hand-off to the ExecManager
                    self._requeue_pending(
                        task.uid, policy.delay(task.name, attempts + 1))
                    return True
                # infra budget exhausted: permanent failure (still journaled
                # pilot_lost so replay never charges the task budget)
                self.svc.advance_seq(task, prefix + (st.FAILED,), exc=exc,
                                     pilot_lost=True, sink=sink)
                self._forget_retry_state(task.uid)
                failed = True
                if stage is not None and pipe is not None:
                    stage.note_task_final(failed)
                    pipe.note_task_failed()
                    self._maybe_finalize_stage(pipe, stage, sink=sink)
                return True
            if msg.get("canceled") or msg.get("exit_code") == -2:
                self._forget_retry_state(task.uid)
                self.svc.advance_seq(task, prefix + (st.CANCELED,), sink=sink)
            elif msg.get("exit_code") == 0:
                self._forget_retry_state(task.uid)
                extras = self._route_result(task)
                if msg.get("plan") is not None:
                    # the fused carrier's chosen execution plan (mesh shape
                    # or lane count) rides the DONE record for postmortem
                    # perf debugging
                    extras.setdefault("plan", msg["plan"])
                self.svc.advance_seq(task, prefix + (st.DONE,),
                                     sink=sink, **extras)
            else:
                exc = str(msg.get("exception", ""))[:500]
                first = self._first_failure.setdefault(
                    task.uid, time.monotonic())
                if policy.should_retry(task, TASK, task.retries, first):
                    # resubmission path (paper: multiple attempts without
                    # restarting completed tasks); the task stays pending in
                    # its stage's countdown. The FAILED hop is published as
                    # its own message — Journal.replay counts discrete
                    # to=FAILED records to restore retry budgets on resume.
                    task.retries += 1
                    tel.counter(RETRY_TOTAL, fault_class=TASK).inc()
                    self.svc.advance_seq(task, prefix + (st.FAILED,),
                                         exc=exc, sink=sink)
                    self.svc.advance_seq(task, (st.SCHEDULING, st.SCHEDULED),
                                         transact=False,
                                         retry=task.retries, sink=sink)
                    if sink is not None:
                        self.svc.flush(sink)  # hand-off to the ExecManager
                    self._requeue_pending(
                        task.uid, policy.delay(task.name, task.retries))
                    return True
                self.svc.advance_seq(task, prefix + (st.FAILED,), exc=exc,
                                     sink=sink)
                self._forget_retry_state(task.uid)
                failed = True
            if stage is not None and pipe is not None:
                stage.note_task_final(failed)
                if failed:
                    pipe.note_task_failed()
                self._maybe_finalize_stage(pipe, stage, sink=sink)
        return True

    def _forget_retry_state(self, uid: str) -> None:
        """Drop per-uid retry bookkeeping once a task reaches a terminal
        state (or succeeds) — the dicts track only in-flight failures."""
        self._infra_retries.pop(uid, None)
        self._first_failure.pop(uid, None)

    def _requeue_pending(self, uid: str, delay: float) -> None:
        """Requeue a retried task, after the policy's backoff if any.

        Backoff rides a daemon Timer rather than blocking the Dequeue loop
        (one straggling retry must not stall the whole completion stream);
        a processor stop cancels outstanding timers."""
        if delay <= 0 or self._stop.is_set():
            self.broker.put(PENDING_QUEUE, uid)
            return
        self.backoff_requeues += 1
        timer = threading.Timer(delay, self._fire_requeue, args=(uid,))
        timer.daemon = True
        with self._lock:
            self._retry_timers = [t for t in self._retry_timers
                                  if t.is_alive()]
            self._retry_timers.append(timer)
        timer.start()

    def _fire_requeue(self, uid: str) -> None:
        if not self._stop.is_set():
            self.broker.put(PENDING_QUEUE, uid)

    def _restore_resumed(self, task: Task, sink: Optional[List[Any]]) -> bool:
        """Resume one task completed in a previous session: skip execution
        and restore its journaled result for data-flow consumers. Returns
        False — schedule the task normally, i.e. re-run the producer — when
        the journaled value cannot be decoded (a spilled fused-array whose
        sidecar file is missing or corrupted): consumers must never receive
        a silently-wrong input on resume."""
        _, resumed_results, _ = self._resume_for(task)
        if task.result is None and task.name in resumed_results:
            try:
                task.result = decode_journal_value(
                    resumed_results[task.name])
            except Exception:  # noqa: BLE001 - undecodable: re-run producer
                return False
        ns = task.tags.get("_wf_ns")
        if ns is not None and (task.name in resumed_results
                               or task.result is not None):
            RESULTS.put(ns, task.name, task.result)
        self.svc.advance_seq(
            task, (st.SCHEDULING, st.SCHEDULED, st.SUBMITTING,
                   st.SUBMITTED, st.EXECUTED, st.DONE),
            resumed=True, sink=sink)
        return True

    def _result_lost(self, task: Task) -> bool:
        """True when a DONE task's value never reached the journal and a
        data-flow consumer may need it: re-run the producer on resume
        instead of resuming it value-less."""
        _, _, result_omitted = self._resume_for(task)
        return (task.name in result_omitted
                and task.tags.get("_wf_ns") is not None)

    def _route_result(self, task: Task) -> Dict[str, Any]:
        """Route a DONE task's return value and decide its journal extra.

        Data-flow routing (declarative API): tasks compiled from
        ``repro.api`` carry their workflow namespace in
        ``task.tags['_wf_ns']``; their results go into the process-global
        :data:`~repro.core.results.STORE` *here* — before the stage-closure
        accounting below makes any consumer schedulable — so a consumer can
        never execute ahead of its inputs.

        Persistence: with a write-ahead journal behind the run, the result
        rides the DONE transition record so resume/replay restores it
        (consumers of a task completed in a previous session still find
        their inputs). Results that JSON cannot round-trip are journaled as
        ``result_omitted`` — replay then re-runs the producer instead of
        silently feeding consumers a corrupted value. Plain workloads
        (result ``None``, or no journal and no namespace) pay nothing.
        """
        ns = task.tags.get("_wf_ns")
        if ns is not None:
            # store even None: a consumer must see "produced None", never
            # "missing" (the store distinguishes the two)
            RESULTS.put(ns, task.name, task.result)
        if not self.svc.durable or (task.result is None and ns is None):
            return {}
        encode = getattr(task.result, "to_journal", None)
        if callable(encode):
            # rich result handle (fused device arrays): journal a tiny
            # codec record (content hash + spill path) instead of a JSON
            # encoding that would blow the result cap; with no sidecar
            # directory fall back to result_omitted → producer re-runs
            try:
                record = encode(self._spill_dir_for(task))
            except Exception:  # noqa: BLE001 - spill failed: omit, re-run
                record = None
            if record is not None:
                return {"result": record}
            return {"result_omitted": True}
        try:
            # must ROUND-TRIP, not merely serialize: int dict keys / tuples
            # survive dumps but come back mutated, which is exactly the
            # silent corruption result_omitted exists to prevent. The size
            # cap bounds both the journal (one JSONL line per result) and
            # this completion-path check; oversized values journal as
            # omitted and their producers simply re-run on resume.
            encoded = json.dumps(task.result)
            if (len(encoded) <= self.RESULT_JOURNAL_CAP
                    and json.loads(encoded) == task.result):
                if (isinstance(task.result, dict)
                        and "__codec__" in task.result):
                    # a plain value of this shape would be dispatched to a
                    # result codec on replay and silently substituted —
                    # omit it so the producer re-runs instead (same guard
                    # philosophy as the {"__future__"} placeholder clash)
                    return {"result_omitted": True}
                return {"result": task.result}
        except (TypeError, ValueError):
            pass
        # last chance before omission: a registered spiller may be able to
        # journal it (array values from fused kernels running on the
        # SCALAR path land here — without the spill, resume would re-run
        # every DONE member of a fuse=False run)
        record = spill_journal_value(task.result, self._spill_dir_for(task))
        if record is not None:
            return {"result": record}
        return {"result_omitted": True}

    # -- stage / pipeline closure -----------------------------------------------#

    def _maybe_finalize_stage(self, pipe: Pipeline, stage: Stage,
                              sink: Optional[List[Any]] = None) -> None:
        if stage.state != st.STAGE_SCHEDULED:
            return
        if stage.pending_tasks != 0:
            return
        if stage.failed_tasks and self.on_task_failure == "fail_stage":
            self.svc.advance(stage, st.STAGE_FAILED, sink=sink)
            pipe.mark_stage_final(stage.uid)
            tel.counter("wfp_stage_closures_total", outcome="failed").inc()
            self._finalize_pipeline(pipe, failed=True, sink=sink)
            return
        self.svc.advance(stage, st.STAGE_DONE, sink=sink)
        pipe.mark_stage_final(stage.uid)
        tel.counter("wfp_stage_closures_total", outcome="done").inc()
        if stage.post_exec is not None:
            # adaptivity: the hook may append stages to the pipeline (the
            # append listener marks it dirty for Enqueue)
            try:
                with tel.span("wfp.post_exec", "wfp", stage=stage.name):
                    stage.post_exec(stage, pipe)
            except Exception:  # noqa: BLE001 - user hook, never fatal
                self.component_errors.append(
                    f"post_exec[{stage.uid}]: {traceback.format_exc(limit=5)}")
        if pipe.completed:
            if not pipe.is_final:
                self._finalize_pipeline(pipe, sink=sink)
            return
        # wake Enqueue only when this closure actually exposed schedulable
        # work: under superstage scheduling the chain's downstream stages
        # are already in flight, and a dirty mark per link closure would
        # cost one full schedule-queue round trip per member per stage —
        # O(members × links) no-op passes on the chain hot path
        nxt = pipe.next_stage()
        if nxt is None:
            if pipe.completed and not pipe.is_final:
                # the cursor caught up through already-final stages
                self._finalize_pipeline(pipe, sink=sink)
        elif nxt.state == st.STAGE_INITIAL:
            self._mark_dirty(pipe.uid)  # next stage is ready to schedule

    def _finalize_pipeline(self, pipe: Pipeline,
                           failed: Optional[bool] = None,
                           sink: Optional[List[Any]] = None) -> None:
        if pipe.is_final:
            # under superstage scheduling a chain's downstream stages are
            # already in flight when fail_stage finalizes the pipeline;
            # their (failed) closures must not re-finalize it — the state
            # machine forbids FAILED->FAILED and the extra decrement would
            # corrupt the open-pipeline count
            return
        if failed is None:
            failed = (pipe.failed_tasks > 0
                      and self.on_task_failure == "fail_stage")
        to = st.PIPELINE_FAILED if failed else st.PIPELINE_DONE
        prefix = ((st.PIPELINE_SCHEDULING,)
                  if pipe.state == st.PIPELINE_INITIAL else ())
        self.svc.advance_seq(pipe, prefix + (to,), sink=sink)
        tel.counter("wfp_pipeline_closures_total",
                    outcome="failed" if failed else "done").inc()
        with self._lock:  # closures arrive under different pipeline locks
            self._open_pipelines -= 1
            if self._open_pipelines <= 0:
                self.done_event.set()
        if self.on_pipeline_final is not None:
            try:
                self.on_pipeline_final(pipe)
            except Exception:  # noqa: BLE001 - service hook, never fatal
                self.component_errors.append(
                    f"on_pipeline_final[{pipe.uid}]: "
                    f"{traceback.format_exc(limit=5)}")
