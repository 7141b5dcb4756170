"""TorchRTS: executes PyTorch computations on device slots.

A pilot on a GPU node is a pool of CUDA devices; a task's ``slots``
requirement is the number of devices its step needs. The TorchRTS extends
the LocalRTS scheduler with a device inventory: when a task starts it is
leased a concrete set of devices, delivered to the task callable through the
``devices=`` keyword (if accepted) so the callable can place its tensors.

The inventory is every visible CUDA device (``torch.cuda.device_count()``),
one named device, or — only when the caller asks for it — the one logical
CPU device. ``slot_oversubscribe`` logical slots share each device. Asking
for CUDA where there is none raises; nothing falls back to the CPU.

Leases are all-or-nothing: a lease that would come up short is a transient
inventory race (e.g. an elastic resize beyond the physical pool), answered by
re-queueing the task (:class:`~repro_torch.rts.base.RequeueTask`) at the
*front* of the queue — never by silently granting fewer devices than
``task.slots``.

Fusion (:mod:`repro_torch.fusion`): the TorchRTS advertises
:meth:`supports_fusion`. Submitted tasks that share a ``_fusion_group`` tag
are packed into *carrier* tasks — one per micro-batch, sized adaptively from
:meth:`free_slots` by the :mod:`~repro_torch.fusion.plans` cost model (tiny
groups fall back to scalar execution). A carrier occupies one member's
worth of devices and executes every member in one batched dispatch via
:mod:`~repro_torch.fusion.engine`, which fans the result out as ordinary
per-member completions. Carrier execution is asynchronous: the worker
thread stacks and enqueues the dispatch, then hands the carrier to a small
pool of completion *drainer* threads, which wait on the dispatch's CUDA
event, fan out, and only then release the device lease.

The chain, DAG and sharded tiers of the JAX package are not ported yet:
:meth:`supports_chain_fusion` and :meth:`supports_dag_fusion` answer False,
and a task tagged ``_fusion_chain`` or ``_fusion_dag`` that reaches
:meth:`submit` anyway fails at once with exit code 2 naming the missing
tier — it is never run some other way.
"""

from __future__ import annotations

import dataclasses
import inspect
import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Set

import torch

from .. import telemetry as tel
from ..core.policies import BreakerBoard
from ..core.pst import Task, resolve_executable
from ..device import DeviceLike, resolve_device
from ..fusion import engine as fusion_engine
from ..fusion.groups import (CHAIN_TAG, DAG_TAG, GROUP_TAG, FusionSpec,
                             fusion_spec)
from ..fusion.plans import DEFAULT_MAX_BATCH, plan_group
from ..telemetry import MetricsRegistry
from .base import Pilot, RequeueTask, ResourceDescription, TaskCompletion
from .local import LocalRTS

#: counter families behind the ``fusion_stats`` snapshot property
FUSION_EVENTS = "rts_fusion_events_total"
CARRIERS_TOTAL = "rts_carriers_total"

_FUSION_STAT_KEYS = ("fused", "scalar_fallback", "failed", "dispatches",
                     "chain_links", "chain_carriers", "sharded_dispatches",
                     "shard_carriers", "dag_carriers", "dag_links",
                     "cross_tenant_carriers", "degraded")

#: tags of the tiers this RTS does not run, with the tier's name
_UNPORTED_TIERS = ((CHAIN_TAG, "chain"), (DAG_TAG, "DAG"))


class _FusedBatch:
    """Carrier-side bookkeeping for one fused micro-batch.

    ``members`` — its tasks; ``pending`` — member uids still owing a
    completion; ``plan`` — the JSON-able plan record stamped onto member
    completions.
    """

    __slots__ = ("members", "pending", "plan")

    def __init__(self, members: List[Task],
                 plan: Optional[Dict[str, Any]] = None) -> None:
        self.members = members
        self.pending: Set[str] = {m.uid for m in members}
        self.plan = plan


def _inventory(device: DeviceLike) -> List[torch.device]:
    """Every visible CUDA device for ``None``/``"cuda"``; else the one
    named device. Raises when CUDA is asked for and absent."""
    if device is None or str(device) == "cuda":
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(device)]


class TorchRTS(LocalRTS):
    def __init__(self, device: DeviceLike = None,
                 devices: Optional[Sequence[torch.device]] = None,
                 slot_oversubscribe: int = 1, fusion: bool = True,
                 fusion_min_batch: Optional[int] = None,
                 fusion_max_batch: int = DEFAULT_MAX_BATCH,
                 breakers: Optional[BreakerBoard] = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._devices = (list(devices) if devices is not None
                         else _inventory(device))
        self._oversubscribe = max(1, slot_oversubscribe)
        self._pool: List[int] = []
        self._leases: Dict[str, List[int]] = {}
        self._pool_lock = threading.Lock()
        self.lease_requeues = 0   # short-lease races answered by requeue
        # -- fusion state ---------------------------------------------------#
        self.fusion = fusion
        self.fusion_min_batch = fusion_min_batch
        self.fusion_max_batch = fusion_max_batch
        self._fusion_lock = threading.Lock()
        self._fused: Dict[str, _FusedBatch] = {}      # carrier uid -> batch
        self._member_carrier: Dict[str, str] = {}     # member uid -> carrier
        self._fused_canceled: Set[str] = set()        # member uids
        # the fusion counters are incremented from the packer, the carrier
        # workers AND the drainer pool: typed locked counters in a
        # per-instance registry, read through the ``fusion_stats`` snapshot
        self.metrics = MetricsRegistry()
        # per-(kernel, tier) breakers over the degrade ladder: a tier that
        # keeps failing is skipped at PACK time (fused → scalar) instead of
        # rediscovered on every dispatch, and re-closes after a probation
        # window through a single half-open probe carrier.
        self.breakers = (breakers if breakers is not None
                         else BreakerBoard(registry=self.metrics))
        self._label_cache: Dict[Any, Optional[str]] = {}
        # -- async data plane -------------------------------------------------#
        # dispatched-but-undrained carriers flow through this queue to a
        # small pool of drainer threads, which own unlease + release: the
        # carrier worker returns as soon as the dispatch is enqueued, so the
        # next carrier's host-side stacking overlaps this one's device
        # compute. A pool (not one thread) so a single hung dispatch
        # head-of-line blocks at most one drainer.
        self._drain_q: "queue.Queue" = queue.Queue()
        self._drainers: List[threading.Thread] = []
        self._n_drainers = 2

    @property
    def fusion_stats(self) -> Dict[str, int]:
        """Point-in-time snapshot of the fusion counters (plain dict, the
        JAX package's keys; tiers not ported here stay 0)."""
        out = {k: 0 for k in _FUSION_STAT_KEYS}
        for labels, c in self.metrics.collect("counter", FUSION_EVENTS):
            out[labels["kind"]] = c.value
        return out

    def _fusion_count(self, kind: str, n: int = 1) -> None:
        self.metrics.counter(FUSION_EVENTS, kind=kind).inc(n)

    def start(self, resources: ResourceDescription) -> Pilot:
        n_logical = len(self._devices) * self._oversubscribe
        if resources.slots > n_logical:
            # clamp a COPY to the inventory: the caller's description must
            # not be mutated; the granted count is reported through the
            # returned pilot's description (the Emgr records it from there)
            resources = dataclasses.replace(resources, slots=n_logical,
                                            extra=dict(resources.extra))
        with self._pool_lock:
            self._pool = list(range(n_logical))
            self._leases = {}
        with self._fusion_lock:
            self._fused.clear()
            self._member_carrier.clear()
            self._fused_canceled.clear()
        self._drain_q = queue.Queue()
        pilot = super().start(resources)
        self._drainers = [
            threading.Thread(target=self._drain_loop,
                             name=f"rts-fusion-drainer-{i}", daemon=True)
            for i in range(self._n_drainers)]
        for t in self._drainers:
            t.start()
        return pilot

    def stop(self) -> None:
        super().stop()
        for _ in self._drainers:
            self._drain_q.put(None)
        for t in self._drainers:
            t.join(timeout=5.0)
        self._drainers = []
        with self._fusion_lock:
            self._fused.clear()
            self._member_carrier.clear()
            self._fused_canceled.clear()

    def resize(self, slots: int) -> int:
        # never grow past the physical inventory: slots without devices
        # behind them would turn every lease into a requeue storm
        slots = min(slots, len(self._devices) * self._oversubscribe)
        return super().resize(slots)

    def free_slots(self) -> Optional[int]:
        """Devices actually leasable right now (inventory, not arithmetic)."""
        with self._pool_lock:
            return len(self._pool)

    def supports_fusion(self) -> bool:
        return self.fusion

    def supports_chain_fusion(self) -> bool:
        """False: composed chains are not ported. The WFProcessor then
        gates chain stages per stage, and they fuse per stage."""
        return False

    def supports_dag_fusion(self) -> bool:
        """False: DAG carriers are not ported."""
        return False

    # -- submission -----------------------------------------------------------#

    def submit(self, tasks: List[Task]) -> None:
        """Fail tasks wider than the whole device inventory, or tagged for
        a tier this RTS does not run, immediately with exit code 2; pack
        fusible groups into carriers, and queue the rest as ordinary scalar
        tasks."""
        inventory = len(self._devices) * self._oversubscribe
        runnable: List[Task] = []
        for task in tasks:
            reason = None
            if task.slots > inventory:
                reason = (f"task requires {task.slots} device slots, "
                          f"inventory is {inventory}")
            for tag, tier in _UNPORTED_TIERS:
                if task.tags.get(tag) is not None:
                    reason = (f"task is tagged {tag} but TorchRTS has no "
                              f"{tier} fusion tier; compile with chain=False")
            if reason is None:
                runnable.append(task)
                continue
            now = time.time()
            self._deliver(TaskCompletion(
                uid=task.uid, exit_code=2, exception=reason,
                started_at=now, completed_at=now))
        if not runnable:
            return
        super().submit(self._pack_fusible(runnable) if self.fusion
                       else runnable)

    def _pack_fusible(self, tasks: List[Task]) -> List[Task]:
        """Group tagged tasks by fusion key; each group becomes carriers
        (micro-batched from the free-device count) plus a scalar remainder
        when the cost model says a batch would be too small to pay off.
        ``free_slots()`` is read ONCE: the plan reflects one consistent
        snapshot of the inventory."""
        groups: Dict[str, List[Task]] = {}
        order: List[Any] = []   # tasks / group keys, in order
        for task in tasks:
            key = task.tags.get(GROUP_TAG)
            if key is None:
                order.append(task)
                continue
            bucket = groups.get(key)
            if bucket is None:
                groups[key] = bucket = []
                order.append((GROUP_TAG, key))
            bucket.append(task)
        if not groups:
            return tasks
        free = self.free_slots()
        out: List[Task] = []
        for entry in order:
            if isinstance(entry, Task):
                out.append(entry)
            else:
                self._pack_group(groups[entry[1]], out, free)
        return out

    def _pack_group(self, members: List[Task], out: List[Task],
                    free: Optional[int]) -> None:
        spec = self._kernel_spec(members[0])
        if spec is None:
            out.extend(members)   # unmarked kernel: never fuse
            return
        label = self._kernel_label_of(members[0])
        if not self.breakers.allow(label, "fused"):
            out.extend(members)   # breaker open: run the ladder's floor
            return
        min_batch = (spec.min_batch if spec.min_batch is not None
                     else self.fusion_min_batch)
        plan = plan_group(len(members), free,
                          members[0].slots, min_batch=min_batch,
                          max_batch=self.fusion_max_batch)
        idx = 0
        for size in plan.batches:
            out.append(self._make_carrier(members[idx:idx + size],
                                          plan=plan.record()))
            idx += size
        out.extend(members[idx:])  # below-threshold remainder: scalar

    @staticmethod
    def _kernel_spec(task: Task) -> Optional[FusionSpec]:
        """The member's FusionSpec, looking through the API trampoline."""
        try:
            if task.executable == fusion_engine.TRAMPOLINE:
                fn = resolve_executable(task.kwargs["__fn__"])
            else:
                fn = task.resolve()
        except Exception:  # noqa: BLE001 - unresolvable: run it scalar
            return None
        return fusion_spec(fn)

    def _kernel_label_of(self, task: Task) -> Optional[str]:
        """The member's telemetry kernel label (the breaker-board key),
        looking through the API trampoline; cached per payload."""
        if task.executable == fusion_engine.TRAMPOLINE:
            key = task.kwargs.get("__fn__")
        else:
            key = task._fn if task._fn is not None else task.executable
        try:
            return self._label_cache[key]
        except (KeyError, TypeError):
            pass
        try:
            if task.executable == fusion_engine.TRAMPOLINE:
                fn = resolve_executable(task.kwargs["__fn__"])
            else:
                fn = task.resolve()
            label = fusion_engine._kernel_label(fn)
        except Exception:  # noqa: BLE001 - no callable: no breaker key
            label = None
        try:
            self._label_cache[key] = label
        except TypeError:
            pass
        return label

    def _make_carrier(self, members: List[Task],
                      plan: Optional[Dict[str, Any]] = None) -> Task:
        batch = _FusedBatch(members, plan=plan)
        hints = [m.duration_hint for m in members
                 if m.duration_hint is not None]
        carrier = Task(
            name=f"fused[{len(members)}]:{members[0].name}",
            executable=f"fused://1x{len(members)}",
            slots=members[0].slots,
            duration_hint=max(hints) if hints else None)
        with self._fusion_lock:
            self._fused[carrier.uid] = batch
            for m in batch.members:
                self._member_carrier[m.uid] = carrier.uid
        return carrier

    # -- cancellation / introspection over carriers ---------------------------#

    def cancel(self, uids: List[str]) -> None:
        """Translate member uids to their carriers: a canceled member is
        skipped at fan-out time; a carrier whose every member is canceled
        is canceled itself (dequeued, or its dispatch interrupted)."""
        translated: List[str] = []
        emptied: List[str] = []
        with self._fusion_lock:
            for u in uids:
                carrier_uid = self._member_carrier.get(u)
                if carrier_uid is None:
                    translated.append(u)
                    continue
                self._fused_canceled.add(u)
                batch = self._fused.get(carrier_uid)
                if batch is not None:
                    batch.pending.discard(u)
                    if not batch.pending:
                        translated.append(carrier_uid)
                        emptied.append(carrier_uid)
        super().cancel(translated)
        if emptied:
            # a fully-canceled carrier dropped from the queue never runs:
            # reclaim its bookkeeping now rather than at stop()
            with self._lock:
                live = set(self._running) | {t.uid for t in self._queue}
            with self._fusion_lock:
                for carrier_uid in emptied:
                    if carrier_uid in live:
                        continue
                    batch = self._fused.pop(carrier_uid, None)
                    if batch is not None:
                        for m in batch.members:
                            self._member_carrier.pop(m.uid, None)
                            self._fused_canceled.discard(m.uid)

    def in_flight(self) -> List[str]:
        """Member uids, never carrier uids: EnTK's custody, failover and
        resubmission logic reasons about the tasks it submitted."""
        base = super().in_flight()
        with self._fusion_lock:
            out: List[str] = []
            for uid in base:
                batch = self._fused.get(uid)
                if batch is None:
                    out.append(uid)
                else:
                    out.extend(batch.pending)
        return out

    def running_since(self) -> Dict[str, float]:
        """Member uids with their carrier's elapsed time: the ExecManager's
        straggler watchdog reasons about the tasks it submitted, so a hung
        fused dispatch must surface as its (still-pending) members — each
        can then be speculatively cloned, and a clone is a lone scalar
        task whose win cancels the member inside the stuck batch."""
        base = super().running_since()
        with self._fusion_lock:
            out: Dict[str, float] = {}
            for uid, elapsed in base.items():
                batch = self._fused.get(uid)
                if batch is None:
                    out[uid] = elapsed
                else:
                    for member_uid in batch.pending:
                        out[member_uid] = elapsed
            return out

    # -- leasing --------------------------------------------------------------#

    def _can_start(self, task: Task) -> bool:
        with self._pool_lock:
            return len(self._pool) >= task.slots

    def _lease(self, task: Task) -> List[Any]:
        with self._pool_lock:
            if len(self._pool) < task.slots:
                # short lease: undo nothing, requeue the task — a partial
                # device set would silently break the task's placement. For
                # a fused carrier this is the whole group's single requeue:
                # members are never requeued individually.
                self.lease_requeues += 1
                raise RequeueTask(
                    f"{task.uid} needs {task.slots} device slots, "
                    f"{len(self._pool)} in pool")
            ids = [self._pool.pop() for _ in range(task.slots)]
            self._leases[task.uid] = ids
        return [self._devices[i % len(self._devices)] for i in ids]

    def _unlease(self, task: Task) -> None:
        with self._pool_lock:
            self._pool.extend(self._leases.pop(task.uid, []))

    # -- execution ------------------------------------------------------------#

    def _run_task(self, task: Task, cancel_event: threading.Event) -> None:
        with self._fusion_lock:
            batch = self._fused.get(task.uid)
        if batch is None:
            return super()._run_task(task, cancel_event)
        self._run_fused(task, batch, cancel_event)

    def _run_fused(self, carrier: Task, batch: _FusedBatch,
                   cancel_event: threading.Event) -> None:
        """Carrier worker: lease devices all-or-nothing, resolve + stack +
        enqueue the batched dispatch, then hand the carrier to the
        completion drainer and RETURN. The drainer owns fan-out, unlease
        and release. No carrier-level fault injection — that is member
        semantics, and the engine applies the injector per member."""
        try:
            devices = self._lease(carrier)
        except RequeueTask:
            self._release(carrier)
            if not self._stop.is_set():
                self._requeue(carrier)   # whole group, once, at the front
            return

        def deliver(c: TaskCompletion) -> None:
            if batch.plan is not None:
                # postmortem perf debugging: every member's journal record
                # carries the carrier's chosen plan
                c.plan = batch.plan
            with self._fusion_lock:
                batch.pending.discard(c.uid)
            self._deliver(c)

        exe = fusion_engine.ChainExecution(
            [batch.members], devices, cancel_event, deliver,
            canceled=self._fused_canceled,
            fault_injector=self.fault_injector)
        self.metrics.counter(CARRIERS_TOTAL, tier=exe.tier).inc()
        # registered BEFORE the dispatch runs: the drainer waits on the
        # carrier's record stream
        self._drain_q.put((carrier, batch, exe))
        with tel.span("carrier.dispatch", "rts",
                      carrier=carrier.name, tier=exe.tier, links=1,
                      width=len(batch.members), members=len(batch.members)):
            exe.dispatch()

    def _record_breaker(self, batch: _FusedBatch, exe: Any, ok: bool) -> None:
        """Feed one carrier outcome to the breaker board under the tier it
        ran. Never raises: breaker accounting must not disturb the
        drainer's unconditional lease release."""
        try:
            tier = getattr(exe, "tier", None)
            if tier is None or not batch.members:
                return
            self.breakers.record(
                self._kernel_label_of(batch.members[0]), tier, ok)
        except Exception:  # noqa: BLE001 - accounting only
            pass

    def _drain_loop(self) -> None:
        """One drainer of the pool: wait for a dispatched carrier's output,
        fan out its completions, then (and only then) return its devices —
        a canceled or crashed carrier can never leak its lease, because
        this release is unconditional."""
        while True:
            item = self._drain_q.get()
            if item is None:
                return
            carrier, batch, exe = item
            try:
                with tel.span("carrier.drain", "rts",
                              carrier=carrier.name,
                              tier=getattr(exe, "tier", "?"),
                              members=len(batch.members)):
                    stats = exe.drain(stop_event=self._stop)
                for k, v in stats.items():
                    if v:
                        self._fusion_count(k, v)
                # breaker board: a carrier that degraded (or fell back to
                # scalar) is a failure OF ITS TIER — member task failures
                # ("failed") are not, the tier executed them correctly
                self._record_breaker(
                    batch, exe,
                    ok=not (stats.get("degraded")
                            or stats.get("scalar_fallback")))
            except Exception:  # noqa: BLE001 - engine failed outside guards
                self._record_breaker(batch, exe, ok=False)
                exc = traceback.format_exc(limit=10)
                now = time.time()
                with self._fusion_lock:
                    undelivered = [m for m in batch.members
                                   if m.uid in batch.pending
                                   and m.uid not in self._fused_canceled]
                for m in undelivered:
                    with self._fusion_lock:
                        batch.pending.discard(m.uid)
                    self._deliver(TaskCompletion(
                        uid=m.uid, exit_code=1, exception=exc,
                        started_at=now, completed_at=now))
            finally:
                self._unlease(carrier)
                self._release(carrier)
                with self._fusion_lock:
                    self._fused.pop(carrier.uid, None)
                    for m in batch.members:
                        self._member_carrier.pop(m.uid, None)
                        self._fused_canceled.discard(m.uid)

    def _execute(self, task: Task, cancel_event: threading.Event,
                 stall: float):
        devices = self._lease(task)
        try:
            fn = None
            try:
                fn = task.resolve()
            except Exception:  # noqa: BLE001 - sleep:// tasks have no callable
                pass
            if fn is None:
                return super()._execute(task, cancel_event, stall)
            try:
                sig = inspect.signature(fn)
                if "devices" in sig.parameters:
                    task.kwargs = dict(task.kwargs)
                    task.kwargs["devices"] = devices
            except (TypeError, ValueError):
                pass
            kernel = fn
            if task.executable == fusion_engine.TRAMPOLINE:
                try:  # label the USER kernel, not the api trampoline
                    kernel = resolve_executable(task.kwargs["__fn__"])
                except Exception:  # noqa: BLE001 - label only, never fatal
                    pass
            t0 = time.perf_counter()
            result = super()._execute(task, cancel_event, stall)
            tel.observe_dispatch(
                getattr(kernel, "__name__", None) or str(kernel),
                "scalar", time.perf_counter() - t0)
            return result
        finally:
            self._unlease(task)
