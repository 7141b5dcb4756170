"""EnsembleService: the persistent multi-tenant daemon core.

One long-lived AppManager (one pilot, one fusion engine, one component
stack) serves many concurrent workflow submissions. Each submission is
compiled through the ordinary declarative API into its own namespace, runs
concurrently with every other tenant's work, and — when ``serve_hold_s``
opens the continuous-batching window — shares carriers with key-compatible
members from *other* tenants: the fusion group key excludes the workflow
namespace by construction, so an ``ensemble(kernel, ...)`` submitted by
tenant A fuses with tenant B's members of the same kernel signature, and
the fan-out routes each completion back to its own ``(namespace, name)``
result key and its own tenant journal.

The default RTS is a :class:`~repro_torch.rts.torch_rts.TorchRTS` on
``device`` (CUDA unless the caller passes ``"cpu"``). Without CUDA and
without ``device="cpu"`` the service raises when it is built: it never
serves from the CPU in place of the card.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Set

from .. import telemetry as tel
from ..core import states as st
from ..core.appmanager import AppManager
from ..core.exceptions import EnTKError
from ..core.results import STORE
from ..device import DeviceLike
from ..rts.torch_rts import SERVE_QUEUE_WAIT, TorchRTS, inventory
from .admission import AdmissionController, AdmissionError
from .fair_share import FairSharePolicy
from .journal import TenantJournals


class SubmissionHandle:
    """One admitted workflow: wait on it, read its results, cancel it.

    Results are read from the process-global store under the submission's
    own namespace — concurrent tenants reusing task names can never see
    each other's values.
    """

    def __init__(self, service: "EnsembleService", tenant: str,
                 compiled: Any, n_members: int) -> None:
        self.service = service
        self.tenant = tenant
        self.compiled = compiled
        self.ns: str = compiled.ns
        self.name: str = compiled.name
        self.n_members = n_members
        self._event = threading.Event()
        self._open: Set[str] = {p.uid for p in compiled.pipelines}

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, name: str) -> Any:
        return STORE.get(self.ns, name)

    def results(self) -> Dict[str, Any]:
        """Every result this submission has produced so far."""
        return {n: STORE.get(self.ns, n) for n in STORE.names(self.ns)}

    def task_states(self) -> Dict[str, str]:
        return {t.name: t.state
                for p in self.compiled.pipelines
                for s in p.stages for t in s.tasks}

    def succeeded(self) -> bool:
        return self.done() and all(
            p.state == st.PIPELINE_DONE for p in self.compiled.pipelines)

    def cancel(self) -> None:
        self.service.cancel(self)

    def metrics(self) -> Dict[str, Any]:
        """This tenant's slice of the service metrics (queue-wait
        quantiles, shared-carrier counts, admission state)."""
        return self.service.metrics().get("tenants", {}).get(
            self.tenant, {})

    def close(self) -> int:
        """Drop this submission's results from the global store."""
        return self.compiled.close()


class EnsembleService:
    """Persistent AppManager + admission gate + fair share + batching.

    ``rts_factory`` defaults to a :class:`~repro_torch.rts.torch_rts.TorchRTS`
    on ``device`` with the continuous-batching window set to
    ``serve_hold_s``; pass your own factory to tune the RTS (set its
    ``serve_hold_s`` yourself then).
    ``journal_root`` enables per-tenant write-ahead journals (and resume);
    without it the service runs non-durable. Fair share + federation is
    not supported in this release: with a federated (multi-resource)
    AppManager the fair-share lanes are bypassed.
    """

    def __init__(self, resources: Any = None,
                 rts_factory: Any = None,
                 journal_root: Optional[str] = None,
                 admission: Optional[AdmissionController] = None,
                 fair_share: Optional[FairSharePolicy] = None,
                 serve_hold_s: float = 0.25,
                 device: DeviceLike = None,
                 **amgr_kwargs: Any) -> None:
        self.serve_hold_s = serve_hold_s
        self.device = device
        if rts_factory is None:
            # resolved now, so a service meant for the card raises here on
            # a machine without CUDA instead of at its first submission
            n_dev = max(1, len(inventory(device)))

            def rts_factory() -> Any:
                # oversubscribe logical slots up to the requested slot
                # count: a physically small pool (one device) would
                # otherwise clamp to one slot and the Emgr would serialize
                # tenants' groups — no two would ever share a batching
                # window
                over = max(1, math.ceil(
                    self.amgr.resources.slots / n_dev))
                return TorchRTS(device=self.device,
                                serve_hold_s=self.serve_hold_s,
                                slot_oversubscribe=over)
        self.admission = admission or AdmissionController()
        self.fair_share = fair_share or FairSharePolicy()
        self.journals = (TenantJournals(journal_root)
                         if journal_root else None)
        self.amgr = AppManager(resources=resources, rts_factory=rts_factory,
                               **amgr_kwargs)
        self._by_pipe: Dict[str, SubmissionHandle] = {}
        self._handles: List[SubmissionHandle] = []
        self._lock = threading.Lock()
        self._started = False
        self._stopping = False

    # -- lifecycle ------------------------------------------------------------#

    def start(self) -> "EnsembleService":
        if self._started:
            raise EnTKError("service already started")
        self.amgr.start_service(journal=self.journals)
        self.amgr.emgr.set_fair_share(self.fair_share)
        self.amgr.wfp.on_pipeline_final = self._on_pipeline_final
        self._started = True
        return self

    def stop(self, drain: bool = True,
             timeout: float = 60.0) -> Dict[str, float]:
        """Stop admitting, optionally drain in-flight submissions, tear
        the component stack down. Idempotent."""
        self._stopping = True
        self.admission.stop_admitting()
        if drain and self._started:
            deadline = time.monotonic() + timeout
            with self._lock:
                handles = list(self._handles)
            for h in handles:
                h.wait(max(0.0, deadline - time.monotonic()))
        totals = self.amgr.stop_service() if self._started else {}
        if self.journals is not None:
            self.journals.close()
        return totals

    # -- submission -----------------------------------------------------------#

    def submit(self, *nodes: Any, tenant: str = "default",
               name: Optional[str] = None, resume: bool = False,
               **compile_kwargs: Any) -> SubmissionHandle:
        """Admit one workflow for ``tenant``.

        ``nodes`` is either declarative API nodes (compiled here) or a
        single pre-``api.compile()``-d workflow. Raises
        :class:`~repro.serve.admission.AdmissionError` (with a stable
        ``code``) when the tenant's quota or the service backlog rejects
        it — nothing is left behind on rejection. ``resume=True`` replays
        THIS tenant's journal only: completed tasks (matched by name) are
        skipped and their recorded results restored."""
        if not self._started:
            raise EnTKError("start() the service before submit()")
        if self._stopping:
            raise AdmissionError("service-stopping",
                                 "service is shutting down")
        from .. import api  # deferred: core service must import without api
        if len(nodes) == 1 and isinstance(nodes[0], api.Compiled):
            compiled = nodes[0]
        else:
            compiled = api.compile(*nodes, name=name, **compile_kwargs)
        tasks = [t for p in compiled.pipelines
                 for s in p.stages for t in s.tasks]
        self.admission.admit(tenant, len(tasks))
        handle = None
        try:
            for t in tasks:
                t.tags["_tenant"] = tenant
            resumed: Dict[str, Any] = {}
            spill_dir = None
            if self.journals is not None:
                self.journals.register(compiled.ns, tenant)
                spill_dir = self.journals.tenant_spill_dir(tenant)
                if resume:
                    replay = self.journals.replay_tenant(tenant)
                    resumed = {
                        "resumed_done": {
                            nm for (kind, nm), state
                            in replay["state"].items()
                            if kind == "task" and state == st.DONE},
                        "resumed_results": dict(replay["results"]),
                        "result_omitted": set(replay["result_omitted"]),
                        "resumed_retries": dict(replay["retries"]),
                    }
            handle = SubmissionHandle(self, tenant, compiled, len(tasks))
            with self._lock:
                for p in compiled.pipelines:
                    self._by_pipe[p.uid] = handle
                self._handles.append(handle)
            self.amgr.submit_pipelines(
                compiled.pipelines, ns=compiled.ns,
                spill_dir=spill_dir, **resumed)
        except Exception:
            with self._lock:
                for p in compiled.pipelines:
                    self._by_pipe.pop(p.uid, None)
                if handle is not None and handle in self._handles:
                    self._handles.remove(handle)
            self.admission.release(tenant, len(tasks))
            raise
        return handle

    def cancel(self, handle: SubmissionHandle) -> None:
        """Cancel one submission; other tenants' work — including members
        sharing a continuous-batching hold with this one — is untouched
        (the RTS drops held members per-uid, never per-key)."""
        self.amgr.cancel_pipelines(handle.compiled.pipelines)

    # -- bookkeeping ----------------------------------------------------------#

    def _on_pipeline_final(self, pipe: Any) -> None:
        with self._lock:
            handle = self._by_pipe.pop(pipe.uid, None)
            if handle is None:
                return
            handle._open.discard(pipe.uid)
            finished = not handle._open
            if finished and handle in self._handles:
                self._handles.remove(handle)
        if finished:
            self.admission.release(handle.tenant, handle.n_members)
            handle._event.set()

    def stats(self) -> Dict[str, Any]:
        rts = self.amgr.emgr.rts if self.amgr.emgr is not None else None
        with self._lock:
            active = len(self._handles)
        return {
            "active_submissions": active,
            "admission": self.admission.snapshot(),
            "fair_share": self.fair_share.snapshot(),
            "fusion": dict(getattr(rts, "fusion_stats", {}) or {}),
            "tenants": {k: dict(v) for k, v in
                        (getattr(rts, "tenant_stats", {}) or {}).items()},
            "telemetry": {
                "kernels": tel.kernels(),
                "tracing_enabled": tel.enabled(),
                "spans_buffered": len(tel.TRACER),
                "dropped_spans": tel.TRACER.dropped_spans,
            },
        }

    def metrics(self) -> Dict[str, Any]:
        """Telemetry snapshot behind the serve protocol's ``metrics`` verb.

        ``exposition`` is Prometheus text — the process-global families
        (per-kernel dispatch-latency quantiles, jit cache, admission)
        followed by this RTS's instance counters (fusion events, tenant
        fan-out, serve-hold queue waits). ``tenants`` breaks the same data
        out per tenant for programmatic consumers."""
        rts = self.amgr.emgr.rts if self.amgr.emgr is not None else None
        reg = getattr(rts, "metrics", None)
        tenant_stats = dict(getattr(rts, "tenant_stats", {}) or {})
        admission = self.admission.snapshot()
        tenants: Dict[str, Any] = {}
        for t in set(tenant_stats) | set(admission):
            ts = tenant_stats.get(t, {})
            tenants[t] = {
                "queue_wait": (reg.quantiles(name=SERVE_QUEUE_WAIT, tenant=t)
                               if reg is not None else {}),
                "members": ts.get("members", 0),
                "shared_carriers": ts.get("shared_dispatches", 0),
                "completions": ts.get("completions", 0),
                "admission": admission.get(t, {}),
            }
        exposition = tel.prometheus_text()
        if reg is not None:
            exposition += reg.prometheus_text()
        return {
            "exposition": exposition,
            "tenants": tenants,
            "tracing": {"enabled": tel.enabled(),
                        "spans_buffered": len(tel.TRACER),
                        "dropped_spans": tel.TRACER.dropped_spans},
        }
