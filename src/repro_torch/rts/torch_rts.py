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

Chain fusion: tasks additionally tagged ``_fusion_chain`` are links of a
cross-stage elementwise chain. The packer re-assembles the links from the
tags (:meth:`supports_chain_fusion`) and builds carriers spanning ALL of a
member cohort's links, so one member-width lease runs the whole chain as
composed dispatches with the intermediates never touching the host. The
drainer fans out the per-stage, per-member completions in link order.

DAG fusion: tasks tagged ``_fusion_dag`` are nodes of a fusable
fan-in/fan-out DAG — ensembles feeding a ``@fusable_reduction`` gather
whose output broadcasts into the next ensemble. The packer re-assembles the
nodes (:meth:`supports_dag_fusion`) and builds exactly ONE carrier per DAG
arrival. A complete round composes into one device segment (``ensemble →
masked reduce → broadcast → ensemble``); resume fragments and ``dag=False``
run the nodes sequentially inside the same carrier (DAG → in-carrier
sequential → per-stage fused → scalar).

Serving mode (:mod:`repro_torch.serve`): ``serve_hold_s > 0`` opens a
continuous-batching window. Fused groups are parked for at most
``serve_hold_s`` seconds from the first hold, so key-compatible members of
OTHER workflows (the fusion key excludes the namespace) land in the same
carriers; the held members are round-robined across tenants before the
planner slices them into lanes, and a full batch (devices x
``fusion_max_batch``) goes out at once. Every carrier is stamped with its
tenant mix, and the per-tenant ``members``, ``shared_dispatches`` and
``completions`` are counted (:attr:`TorchRTS.tenant_stats`). Chain and DAG
tasks are never held: they go to their assemblers as before.

Sharded tier: a fusion group (or chain cohort, or complete DAG round) wide
enough to clear ``shard_min_members`` on an inventory of two or more
distinct places — CUDA devices, or lanes of one device
(:func:`~repro_torch.device.virtual_devices`, which tests and the card
check build; ``TorchRTS()`` lists real cards only) — is planned as a
**mesh** (:func:`~repro_torch.fusion.plans.plan_mesh`) instead of
micro-batch lanes: each sharded carrier takes ONE all-or-nothing lease of
``places x member_slots`` slots and the engine runs the batch split on its
member axis, one shard per place. Wide groups whose members arrive in
pieces are held (``shard_hold_s``, an idle timeout) until a full-mesh
batch accumulates. ``shard=False`` (or a ``_no_shard`` member tag) opts
out; a lease that collapses short (an oversubscribed pool) runs on one
device. The plan is stamped on every member completion, and
:meth:`TorchRTS.planned_group_slots` charges the whole mesh.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Set

import torch

from .. import telemetry as tel
from ..core.policies import BreakerBoard
from ..core.pst import Task, resolve_executable
from ..device import DeviceLike, VirtualDevice, resolve_device
from ..fusion import engine as fusion_engine
from ..fusion.groups import (GROUP_TAG, FusionSpec, fusion_spec,
                             parse_chain_tag, parse_dag_tag)
from ..fusion.plans import (DEFAULT_MAX_BATCH, DEFAULT_MIN_CHAIN,
                            DEFAULT_SHARD_MIN_MEMBERS, MeshPlan, plan_chain,
                            plan_dag, plan_group, plan_mesh)
from ..telemetry import MetricsRegistry
from .base import Pilot, RequeueTask, ResourceDescription, TaskCompletion
from .local import LocalRTS

#: counter families behind the ``fusion_stats`` / ``tenant_stats`` snapshot
#: properties, the serve hold's events and its per-tenant queue wait
FUSION_EVENTS = "rts_fusion_events_total"
TENANT_EVENTS = "rts_tenant_events_total"
SERVE_HOLD_EVENTS = "rts_serve_hold_events_total"
SERVE_QUEUE_WAIT = "serve_queue_wait_seconds"
CARRIERS_TOTAL = "rts_carriers_total"

_FUSION_STAT_KEYS = ("fused", "scalar_fallback", "failed", "dispatches",
                     "chain_links", "chain_carriers", "sharded_dispatches",
                     "shard_carriers", "dag_carriers", "dag_links",
                     "cross_tenant_carriers", "degraded",
                     # the sharded tier's link graphs (CUDA places only)
                     *fusion_engine.GRAPH_STATS)
_TENANT_FIELDS = ("members", "shared_dispatches", "completions")


class _FusedBatch:
    """Carrier-side bookkeeping for one fused micro-batch.

    ``links`` — one aligned task list per chain link (a plain fused group
    is a 1-link chain); for a DAG carrier (``dag=True``) one task list per
    DAG *node* instead, with reduction nodes holding a single reduce task;
    ``members`` — every member task across links; ``pending`` — member
    uids still owing a completion; ``compose`` — whether the links run as
    composed segments; ``mesh_shards`` — place count of a planned mesh (0 =
    plain micro-batch carrier); ``plan`` — the JSON-able plan record
    stamped onto member completions.
    """

    __slots__ = ("links", "members", "pending", "compose", "mesh_shards",
                 "plan", "dag")

    def __init__(self, links: List[List[Task]], compose: bool = True,
                 mesh_shards: int = 0,
                 plan: Optional[Dict[str, Any]] = None,
                 dag: bool = False) -> None:
        self.links = links
        self.members = [t for link in links for t in link]
        self.pending: Set[str] = {m.uid for m in self.members}
        self.compose = compose
        self.mesh_shards = mesh_shards
        self.plan = plan
        self.dag = dag


def inventory(device: DeviceLike) -> List[torch.device]:
    """Every visible CUDA device for ``None``/``"cuda"``; else the one
    named device. Raises when CUDA is asked for and absent."""
    if device is None or str(device) == "cuda":
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(device)]


def _tenant_of(task: Task) -> Optional[str]:
    """The tenant a member bills to: its service tenant, else its workflow
    namespace, else ``None``."""
    return task.tags.get("_tenant") or task.tags.get("_wf_ns")


class TorchRTS(LocalRTS):
    def __init__(self, device: DeviceLike = None,
                 devices: Optional[Sequence[Any]] = None,
                 slot_oversubscribe: int = 1, fusion: bool = True,
                 fusion_min_batch: Optional[int] = None,
                 fusion_max_batch: int = DEFAULT_MAX_BATCH,
                 fusion_min_chain: int = DEFAULT_MIN_CHAIN,
                 dag: bool = True,
                 shard: bool = True,
                 shard_min_members: int = DEFAULT_SHARD_MIN_MEMBERS,
                 shard_hold_s: float = 0.25,
                 serve_hold_s: float = 0.0,
                 breakers: Optional[BreakerBoard] = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._devices = (list(devices) if devices is not None
                         else inventory(device))
        self._oversubscribe = max(1, slot_oversubscribe)
        self._pool: List[int] = []
        self._leases: Dict[str, List[int]] = {}
        self._pool_lock = threading.Lock()
        self.lease_requeues = 0   # short-lease races answered by requeue
        # -- fusion state ---------------------------------------------------#
        self.fusion = fusion
        self.fusion_min_batch = fusion_min_batch
        self.fusion_max_batch = fusion_max_batch
        self.fusion_min_chain = max(2, fusion_min_chain)
        # dag=False declines DAG *composition* only: DAG-tagged tasks still
        # execute inside one carrier (sequential per-node — the carrier is
        # what orders the reduce after its members), just never as one
        # composed segment
        self.dag = dag
        self.shard = shard
        self.shard_min_members = shard_min_members
        self.shard_hold_s = shard_hold_s
        # serving mode: >0 opens a continuous-batching window — fusible
        # groups are parked briefly so same-kernel members from OTHER
        # workflows (the fusion key excludes the namespace) can land in the
        # same carriers. The window is a hard deadline, not an idle
        # timeout: under a steady multi-tenant stream an idle re-arm would
        # never fire and small tenants would starve behind it.
        self.serve_hold_s = serve_hold_s
        self._meshable: Optional[bool] = None   # lazily checked place types
        # -- shard and serve hold buffer ------------------------------------#
        # members of a wide group arrive as a stream of partial submissions
        # (the Broker hands the Emgr what the WFP has enqueued so far);
        # packing each partial slice would fragment the group into many
        # small mesh dispatches. Groups whose compile-time width hint
        # (``_fusion_width``) says more members are coming are held here
        # until a full-mesh batch (places x max_batch) accumulates, the
        # whole group has arrived, or ``shard_hold_s`` passes without
        # progress — whichever is first. The serve hold shares the buffer.
        self._held: Dict[str, List[Task]] = {}
        self._hold_seen: Dict[str, int] = {}
        self._hold_timers: Dict[str, threading.Timer] = {}
        self._hold_arrived: Dict[str, float] = {}   # member uid -> hold t0
        self._hold_lock = threading.Lock()
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
        JAX package's keys and the sharded tier's graph counts)."""
        out = {k: 0 for k in _FUSION_STAT_KEYS}
        for labels, c in self.metrics.collect("counter", FUSION_EVENTS):
            out[labels["kind"]] = c.value
        return out

    @property
    def tenant_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant fan-out accounting snapshot: tenant label ->
        ``{"members", "shared_dispatches", "completions"}``. A member's
        tenant label is its ``_tenant`` tag (stamped by the serving layer)
        or, absent that, its workflow namespace."""
        out: Dict[str, Dict[str, int]] = {}
        for labels, c in self.metrics.collect("counter", TENANT_EVENTS):
            ts = out.setdefault(labels["tenant"],
                                {f: 0 for f in _TENANT_FIELDS})
            ts[labels["field"]] = c.value
        return out

    def _fusion_count(self, kind: str, n: int = 1) -> None:
        self.metrics.counter(FUSION_EVENTS, kind=kind).inc(n)

    def _tenant_count(self, tenant: str, field: str, n: int = 1) -> None:
        self.metrics.counter(TENANT_EVENTS, tenant=tenant, field=field).inc(n)

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
        with self._hold_lock:
            for timer in self._hold_timers.values():
                timer.cancel()
            self._hold_timers.clear()
            self._held.clear()
            self._hold_seen.clear()
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

    def planned_group_slots(self, n_members: int, member_slots: int) -> int:
        """Slots the Emgr should charge for one fusible group right now:
        a group wide enough to shard occupies the WHOLE mesh for its
        dispatch, so the Emgr must not pack other work into those slots
        (the micro-batch case keeps the one-member charge — lanes backfill
        into genuinely free capacity)."""
        mesh = self._plan_mesh(n_members, self.free_slots(), member_slots,
                               None)
        if mesh is not None:
            return mesh.n_shards * member_slots
        return member_slots

    def supports_chain_fusion(self) -> bool:
        """True when this RTS composes ``_fusion_chain``-tagged stages into
        multi-link carriers (fusion on). The WFProcessor only *superstages*
        (hands a chain's downstream stages off together with the entry
        stage) against an RTS that answers True — everywhere else, stage
        ordering keeps gating submissions."""
        return self.fusion

    def supports_dag_fusion(self) -> bool:
        """True when this RTS assembles ``_fusion_dag``-tagged nodes into
        whole-round carriers (fusion on). This gates *routing*, not
        composition: ``dag=False`` still routes DAG tasks through a
        carrier (sequential per-node) because the reduce must be ordered
        after its member inputs."""
        return self.fusion

    # -- submission -----------------------------------------------------------#

    def submit(self, tasks: List[Task]) -> None:
        """Reject tasks wider than the whole device inventory immediately
        with exit code 2 (they could never start), pack fusible groups,
        chains and DAGs into carriers, and queue the rest as ordinary
        scalar tasks."""
        inventory = len(self._devices) * self._oversubscribe
        runnable: List[Task] = []
        for task in tasks:
            if task.slots > inventory:
                now = time.time()
                self._deliver(TaskCompletion(
                    uid=task.uid, exit_code=2,
                    exception=(f"task requires {task.slots} device slots, "
                               f"inventory is {inventory}"),
                    started_at=now, completed_at=now))
            else:
                runnable.append(task)
        if not runnable:
            return
        super().submit(self._pack_fusible(runnable) if self.fusion
                       else runnable)

    def _pack_fusible(self, tasks: List[Task]) -> List[Task]:
        """Group tagged tasks by fusion key; each group becomes carriers
        (micro-batched from the free-device count) plus a scalar remainder
        when the cost model says a batch would be too small to pay off.
        ``_fusion_chain``- and ``_fusion_dag``-tagged tasks are first
        re-assembled into chain and DAG carriers spanning every link or
        node present in this submission. ``free_slots()`` is read ONCE: the
        plan reflects one consistent snapshot of the inventory."""
        groups: Dict[str, List[Task]] = {}
        chains: Dict[str, Dict[int, Dict[int, Task]]] = {}  # c->member->link
        dags: Dict[str, Dict[int, Dict[int, Task]]] = {}    # c->node->member
        order: List[Any] = []   # tasks / group keys / chain ids, in order
        for task in tasks:
            dtag = parse_dag_tag(task.tags)
            if dtag is not None:
                # like chains, ALWAYS routed through the assembler — even
                # with the dag knob off, a reduce task must execute inside
                # a carrier that orders it after its members
                per_node = dags.get(dtag["c"])
                if per_node is None:
                    dags[dtag["c"]] = per_node = {}
                    order.append(("dag", dtag["c"]))
                per_node.setdefault(dtag["k"], {})[dtag["m"]] = task
                continue
            chain = parse_chain_tag(task.tags)
            if chain is not None:
                # ALWAYS routed through the assembler — even chains the
                # min_chain policy declines to compose execute inside a
                # carrier (per-stage, link-ordered): superstaged downstream
                # links must never run as free-floating concurrent tasks
                per_member = chains.get(chain["c"])
                if per_member is None:
                    chains[chain["c"]] = per_member = {}
                    order.append(("chain", chain["c"]))
                per_member.setdefault(chain["m"], {})[chain["k"]] = task
                continue
            key = task.tags.get(GROUP_TAG)
            if key is None:
                order.append(task)
                continue
            bucket = groups.get(key)
            if bucket is None:
                groups[key] = bucket = []
                order.append((GROUP_TAG, key))
            bucket.append(task)
        if not groups and not chains and not dags:
            return tasks
        free = self.free_slots()
        out: List[Task] = []
        for entry in order:
            if isinstance(entry, Task):
                out.append(entry)
            elif entry[0] == "dag":
                self._assemble_dag(dags[entry[1]], out, free)
            elif entry[0] == "chain":
                self._assemble_chain(chains[entry[1]], out, free)
            elif (self.serve_hold_s > 0
                  and self._kernel_spec(groups[entry[1]][0]) is not None):
                self._serve_hold(entry[1], groups[entry[1]], out, free)
            else:
                self._pack_or_hold(entry[1], groups[entry[1]], out, free)
        return out

    def _serve_hold(self, key: str, members: List[Task], out: List[Task],
                    free: Optional[int]) -> None:
        """Continuous batching (serving mode): park a fused group so
        key-compatible members from other tenants can join its carriers.

        Capacity-sized batches go out immediately (a full batch gains
        nothing by waiting) and the remainder waits for a HARD
        ``serve_hold_s`` deadline rather than an idle re-arm, so a lone
        tenant's tail is never starved by a busy neighbour keeping the
        stream "active". Cancellation, ``in_flight`` and ``stop`` see the
        held members."""
        capacity = max(1, len(self._devices) * self.fusion_max_batch)
        arm_key = None
        now = time.perf_counter()
        with self._hold_lock:
            opened = key not in self._held
            held = self._held.setdefault(key, [])
            held.extend(members)
            for m in members:
                self._hold_arrived[m.uid] = now
            self._hold_seen[key] = self._hold_seen.get(key, 0) + len(members)
            batches: List[List[Task]] = []
            while len(held) >= capacity:
                batches.append(held[:capacity])
                del held[:capacity]
            if not held:
                self._held.pop(key, None)
                self._hold_seen.pop(key, None)
                timer = self._hold_timers.pop(key, None)
                if timer is not None:
                    timer.cancel()
            elif key not in self._hold_timers:
                arm_key = key   # deadline runs from the FIRST hold
        self.metrics.counter(
            SERVE_HOLD_EVENTS, event="open" if opened else "extend").inc()
        tel.event("serve.hold", "serve", key=key,
                  event="open" if opened else "extend", n=len(members))
        for batch in batches:
            self.metrics.counter(SERVE_HOLD_EVENTS,
                                 event="capacity_flush").inc()
            self._observe_hold_wait(batch)
            self._pack_group(self._interleave_tenants(batch), out, free)
        if arm_key is not None:
            timer = threading.Timer(self.serve_hold_s, self._flush_serve,
                                    args=(arm_key,))
            timer.daemon = True
            with self._hold_lock:
                if arm_key in self._held and arm_key not in self._hold_timers:
                    self._hold_timers[arm_key] = timer
                    timer.start()

    def _flush_serve(self, key: str) -> None:
        """Deadline flush for a serve-held group, on the timer's thread:
        pack whatever accumulated, unconditionally — no busy/progress
        re-arm. Nothing is submitted once the RTS is stopping."""
        if self._stop.is_set():
            return
        with self._hold_lock:
            members = self._held.pop(key, None)
            self._hold_seen.pop(key, None)
            self._hold_timers.pop(key, None)
        if not members:
            return
        self.metrics.counter(SERVE_HOLD_EVENTS, event="deadline_flush").inc()
        tel.event("serve.hold", "serve", key=key, event="deadline_flush",
                  n=len(members))
        self._observe_hold_wait(members)
        out: List[Task] = []
        self._pack_group(self._interleave_tenants(members), out,
                         self.free_slots())
        if out:
            super().submit(out)

    def _observe_hold_wait(self, members: List[Task]) -> None:
        """Serve-hold queue wait, per tenant: time from landing in the hold
        buffer to being packed into a carrier."""
        now = time.perf_counter()
        with self._hold_lock:
            waits = [(m, self._hold_arrived.pop(m.uid, None))
                     for m in members]
        for m, t0 in waits:
            if t0 is None:
                continue
            label = _tenant_of(m) or "-"
            self.metrics.histogram(SERVE_QUEUE_WAIT, tenant=label) \
                .observe(now - t0)

    @staticmethod
    def _interleave_tenants(members: List[Task]) -> List[Task]:
        """Round-robin members across tenants before packing.

        A hold accumulates members in arrival order — one tenant's whole
        sweep, then the next — and the planner slices carriers off that
        sequence, which would hand each carrier back to a single tenant.
        Interleaving makes every carrier a cross-tenant mix AND every
        dispatch deliver progress to every waiting tenant (per-member
        order within a tenant is preserved)."""
        by_tenant: Dict[Any, List[Task]] = {}
        for m in members:
            label = _tenant_of(m)
            by_tenant.setdefault(label, []).append(m)
        if len(by_tenant) <= 1:
            return members
        queues = [list(reversed(q)) for q in by_tenant.values()]
        mixed: List[Task] = []
        while queues:
            queues = [q for q in queues if q]
            for q in queues:
                mixed.append(q.pop())
        return mixed

    def _n_places(self) -> int:
        """Distinct places in the inventory: oversubscribed logical slots
        and a device listed twice widen lanes, never meshes."""
        return len(set(self._devices))

    def _pack_or_hold(self, key: str, members: List[Task], out: List[Task],
                      free: Optional[int]) -> None:
        """Pack a fused group now, or hold a partially-arrived wide one.

        Holding applies only when the mesh planner could fire for the full
        group (shard on, two or more places, no ``_no_shard``) and the
        compile-time width hint says members beyond this submission are
        still in flight. Full-mesh batches are emitted as they fill; the
        remainder waits for the rest of the group or the ``shard_hold_s``
        idle timeout."""
        tags = members[0].tags
        width = int(tags.get("_fusion_width") or 0)
        if (not self.shard or self._n_places() < 2
                or not self._mesh_capable() or tags.get("_no_shard")
                or width < self.shard_min_members
                or self._kernel_spec(members[0]) is None):
            self._pack_group(members, out, free)
            return
        # emit in equal quanta sized so the whole group needs exactly
        # ceil(width / (places x max_batch)) dispatches — the planner's
        # dispatch bound — while early quanta still overlap the stream
        capacity = self._n_places() * self.fusion_max_batch
        target = math.ceil(width / max(1, math.ceil(width / capacity)))
        arm_key = None
        with self._hold_lock:
            held = self._held.setdefault(key, [])
            held.extend(members)
            seen = self._hold_seen.get(key, 0) + len(members)
            self._hold_seen[key] = seen
            batches: List[List[Task]] = []
            while len(held) >= target:
                batches.append(held[:target])
                del held[:target]
            if held and seen >= width:
                batches.append(held[:])   # the whole group has arrived
                del held[:]
            if not held:
                self._held.pop(key, None)
                self._hold_seen.pop(key, None)
                timer = self._hold_timers.pop(key, None)
                if timer is not None:
                    timer.cancel()
            elif key not in self._hold_timers:
                arm_key = key    # idle timer runs from the FIRST hold
        for batch in batches:
            self._pack_group(batch, out, free)
        if arm_key is not None:
            self._arm_hold_timer(arm_key)

    def _arm_hold_timer(self, key: str) -> None:
        """Arm (or re-arm) the inactivity timer for a held group; the seen
        count at arm time lets the flush tell a stalled stream from one
        that is still making progress."""
        with self._hold_lock:
            if key not in self._held or key in self._hold_timers:
                return
            timer = threading.Timer(self.shard_hold_s, self._flush_held,
                                    args=(key, self._hold_seen.get(key, 0)))
            timer.daemon = True
            self._hold_timers[key] = timer
        timer.start()

    def _flush_held(self, key: Optional[str] = None,
                    seen_at_arm: Optional[int] = None) -> None:
        """Inactivity flush: pack whatever a held group accumulated.

        ``shard_hold_s`` is an idle timeout, not an absolute deadline:
        while the Emgr is still streaming group members in, or carriers
        are queued or running (the stream only looks stalled because the
        scheduler waits out this group's own earlier quanta), the timer
        re-arms instead of fragmenting the hold into undersized packs. A
        partial hold flushes only once the RTS is otherwise idle AND the
        stream made no progress for a full period."""
        busy = False
        if key is not None and seen_at_arm is not None:
            with self._lock:
                busy = bool(self._running) or bool(self._queue)
        with self._hold_lock:
            rearm = False
            if key is not None and seen_at_arm is not None:
                self._hold_timers.pop(key, None)
                rearm = key in self._held and (
                    busy or self._hold_seen.get(key, 0) > seen_at_arm)
            keys = [] if rearm else (
                [key] if key is not None else list(self._held))
            flushed: List[List[Task]] = []
            for k in keys:
                members = self._held.pop(k, None)
                self._hold_seen.pop(k, None)
                timer = self._hold_timers.pop(k, None)
                if timer is not None:
                    timer.cancel()
                if members:
                    flushed.append(members)
        if rearm:
            self._arm_hold_timer(key)
            return
        out: List[Task] = []
        for members in flushed:
            self._pack_group(members, out, self.free_slots())
        if out:
            super().submit(out)

    def _mesh_capable(self) -> bool:
        """True when every place of the inventory can join a mesh: all
        lanes (:class:`~repro_torch.device.VirtualDevice`) or all CUDA
        devices. Reads the inventory's types only: planning never touches
        CUDA."""
        if self._meshable is None:
            devs = self._devices
            self._meshable = bool(devs) and (
                all(isinstance(d, VirtualDevice) for d in devs)
                or all(isinstance(d, torch.device) and d.type == "cuda"
                       for d in devs))
        return self._meshable

    def _plan_mesh(self, n_members: int, free: Optional[int],
                   member_slots: int,
                   tags: Optional[Dict[str, Any]]) -> Optional[MeshPlan]:
        """Mesh plan for a wide group, or None → micro-batch lanes.

        The free count is clamped to the scheduler's slot total so a mesh
        carrier can never be planned wider than the pilot will ever admit,
        and the mesh is capped at the distinct place count."""
        if not self.shard or not self._mesh_capable():
            return None
        if tags is not None and tags.get("_no_shard"):
            return None
        if free is not None:
            free = min(free, self._slots_total)
        return plan_mesh(n_members, free, member_slots,
                         max_batch=self.fusion_max_batch,
                         shard_min_members=self.shard_min_members,
                         max_devices=self._n_places())

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
        mesh = self._plan_mesh(len(members), free, members[0].slots,
                               members[0].tags)
        if mesh is not None and not self.breakers.allow(label, "shard"):
            mesh = None           # breaker open: micro-batch lanes instead
        if mesh is not None:
            record = mesh.record()
            idx = 0
            for size in mesh.batches:
                out.append(self._make_carrier(
                    [members[idx:idx + size]], mesh_shards=mesh.n_shards,
                    plan=record))
                idx += size
            return
        min_batch = (spec.min_batch if spec.min_batch is not None
                     else self.fusion_min_batch)
        plan = plan_group(len(members), free,
                          members[0].slots, min_batch=min_batch,
                          max_batch=self.fusion_max_batch)
        idx = 0
        for size in plan.batches:
            out.append(self._make_carrier([members[idx:idx + size]],
                                          plan=plan.record()))
            idx += size
        out.extend(members[idx:])  # below-threshold remainder: scalar

    def _assemble_chain(self, per_member: Dict[int, Dict[int, Task]],
                        out: List[Task], free: Optional[int]) -> None:
        """Build chain carriers from the links present in this submission.

        Members are grouped into *cohorts* by the link range they submit
        (a fresh run submits every member at link 0; a resumed run submits
        survivors at the first un-journaled link and failed members at
        their failure link — different cohorts, each re-entering the chain
        mid-way). A cohort's links must be a contiguous range — the
        superstage hand-off and the Emgr's whole-chain drain guarantee it —
        and each cohort is micro-batched like a fused group, except that
        there is never a scalar remainder (the carrier is what orders link
        k before link k+1; see :func:`repro_torch.fusion.plans.plan_chain`).
        Single-link cohorts fall back to plain per-stage fused groups.
        """
        cohorts: Dict[Optional[tuple], List[int]] = {}
        for m in sorted(per_member):
            links = tuple(sorted(per_member[m]))
            contiguous = links == tuple(range(links[0], links[0] + len(links)))
            cohorts.setdefault(links if contiguous else None, []).append(m)
        for links, member_idxs in cohorts.items():
            if links is None or len(links) < 2:
                # single link (or a defensive non-contiguous surprise):
                # per-stage fused groups, keyed by each task's own group tag
                regroup: Dict[str, List[Task]] = {}
                for m in member_idxs:
                    for task in per_member[m].values():
                        key = task.tags.get(GROUP_TAG) or "?"
                        regroup.setdefault(key, []).append(task)
                for members in regroup.values():
                    self._pack_group(members, out, free)
                continue
            entry = per_member[member_idxs[0]][links[0]]
            label = self._kernel_label_of(entry)
            compose = (len(links) >= self.fusion_min_chain
                       and self.breakers.allow(label, "chain"))
            mesh = self._plan_mesh(len(member_idxs), free, entry.slots,
                                   entry.tags) if compose else None
            if mesh is not None and not self.breakers.allow(label, "shard"):
                mesh = None
            if mesh is not None:
                sizes, mesh_shards, record = \
                    mesh.batches, mesh.n_shards, mesh.record()
            else:
                sizes = plan_chain(len(member_idxs), free, entry.slots,
                                   max_batch=self.fusion_max_batch)
                mesh_shards, record = 0, {"kind": "fused",
                                          "lanes": len(sizes), "scalar": 0}
            idx = 0
            for size in sizes:
                cohort = member_idxs[idx:idx + size]
                link_lists = [[per_member[m][k] for m in cohort]
                              for k in links]
                out.append(self._make_carrier(link_lists, compose=compose,
                                              mesh_shards=mesh_shards,
                                              plan=record))
                idx += size

    def _assemble_dag(self, per_node: Dict[int, Dict[int, Task]],
                      out: List[Task], free: Optional[int] = None) -> None:
        """Build ONE carrier from whatever nodes of a DAG round arrived.

        Unlike chains, a DAG is never split into lanes or scattered into
        per-stage groups: its reduction node consumes every member future,
        so any concurrent split would race the reduce against its own
        inputs. Every arrival — complete round or resume fragment — becomes
        a single carrier. The carrier *composes* (one device segment over
        ``ensemble → reduce → broadcast → ensemble``) only when the round
        is complete (all ``n`` nodes present at their tagged width) and
        within the batch bound; otherwise it runs its nodes sequentially
        in-carrier, which preserves ordering and per-member semantics for
        fragments re-entering mid-round. A composed round whose ensemble
        nodes share one width, with only kind-tagged reductions (a custom
        combine would see one shard only), may shard across the mesh.
        """
        node_ids = sorted(per_node)
        links = [[per_node[k][m] for m in sorted(per_node[k])]
                 for k in node_ids]
        first = links[0][0]
        n_total = int((parse_dag_tag(first.tags) or {}).get("n")
                      or len(node_ids))
        complete = node_ids == list(range(n_total))
        tags = [parse_dag_tag(node[0].tags) or {} for node in links]
        if complete:
            complete = all(len(node) == int(t.get("w") or 1)
                           for node, t in zip(links, tags))
        e_widths = {len(node) for node, t in zip(links, tags)
                    if t.get("r") != "r"}
        width = max(len(node) for node in links)
        plan = plan_dag(n_total, width, dag=self.dag,
                        max_batch=self.fusion_max_batch)
        label = self._kernel_label_of(first)
        composed = (plan.composed and complete
                    and self.breakers.allow(label, "dag"))
        mesh = None
        if (composed and len(e_widths) == 1
                and all(t.get("rk") for t in tags if t.get("r") == "r")):
            mesh = self._plan_mesh(width, free, first.slots, first.tags)
        if mesh is not None and not self.breakers.allow(label, "shard"):
            mesh = None
        if mesh is not None:
            plan = plan_dag(n_total, width, dag=self.dag,
                            max_batch=self.fusion_max_batch,
                            n_shards=mesh.n_shards)
        out.append(self._make_carrier(
            links, compose=composed,
            mesh_shards=mesh.n_shards if mesh is not None else 0,
            plan=plan.record(), dag=True))

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

    def _make_carrier(self, links: List[List[Task]], compose: bool = True,
                      mesh_shards: int = 0,
                      plan: Optional[Dict[str, Any]] = None,
                      dag: bool = False) -> Task:
        # tenant accounting: the planners REUSE one plan record dict across
        # a group's carriers, so copy before stamping this carrier's tenant
        # mix onto it (the stamp differs per carrier)
        tenants = {_tenant_of(m) for link in links for m in link}
        tenants.discard(None)
        if plan is not None:
            plan = dict(plan)
            plan["tenants"] = max(1, len(tenants))
        batch = _FusedBatch(links, compose=compose, mesh_shards=mesh_shards,
                            plan=plan, dag=dag)
        hints = [m.duration_hint for m in batch.members
                 if m.duration_hint is not None]
        n = len(links)
        width = max(len(node) for node in links) if dag else len(links[0])
        if dag and mesh_shards:
            name = f"dag-shard[{mesh_shards}x{n}x{width}]:{links[0][0].name}"
        elif dag:
            name = f"dag[{n}x{width}]:{links[0][0].name}"
        elif mesh_shards:
            name = f"shard[{mesh_shards}x{n}x{width}]:{links[0][0].name}"
        elif n == 1:
            name = f"fused[{width}]:{links[0][0].name}"
        else:
            name = f"chain[{n}x{width}]:{links[0][0].name}"
        carrier = Task(
            name=name, executable=f"fused://{n}x{width}",
            # a sharded carrier leases the WHOLE mesh all-or-nothing: one
            # member-width of slots per place
            slots=links[0][0].slots * max(1, mesh_shards),
            duration_hint=max(hints) if hints else None)
        with self._fusion_lock:
            self._fused[carrier.uid] = batch
            for m in batch.members:
                self._member_carrier[m.uid] = carrier.uid
        # counters are individually locked: no need to hold _fusion_lock
        if len(tenants) > 1:
            self._fusion_count("cross_tenant_carriers")
        for label in tenants:
            self._tenant_count(label, "members", sum(
                1 for m in batch.members
                if _tenant_of(m) == label))
            if len(tenants) > 1:
                self._tenant_count(label, "shared_dispatches")
        if dag:
            self._fusion_count("dag_carriers")
        elif n > 1:
            self._fusion_count("chain_carriers")
        if mesh_shards:
            self._fusion_count("shard_carriers")
        return carrier

    # -- cancellation / introspection over carriers ---------------------------#

    def cancel(self, uids: List[str]) -> None:
        """Translate member uids to their carriers: a canceled member is
        skipped at fan-out time; a carrier whose every member is canceled
        is canceled itself (dequeued, or its dispatch interrupted). Members
        still parked in the shard or serve hold are simply dropped, and a
        hold they empty stops its timer."""
        wanted = set(uids)
        with self._hold_lock:
            for k in list(self._held):
                kept = [t for t in self._held[k] if t.uid not in wanted]
                if not kept:
                    self._held.pop(k)
                    self._hold_seen.pop(k, None)
                    timer = self._hold_timers.pop(k, None)
                    if timer is not None:
                        timer.cancel()
                elif len(kept) != len(self._held[k]):
                    self._held[k] = kept
            for u in wanted:
                self._hold_arrived.pop(u, None)
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
        resubmission logic reasons about the tasks it submitted. Members
        parked in the shard or serve hold are in flight too — they have
        been accepted and will run at the latest when the hold flushes."""
        base = super().in_flight()
        with self._fusion_lock:
            out: List[str] = []
            for uid in base:
                batch = self._fused.get(uid)
                if batch is None:
                    out.append(uid)
                else:
                    out.extend(batch.pending)
        with self._hold_lock:
            for ms in self._held.values():
                out.extend(t.uid for t in ms)
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
        enqueue the batched dispatches, then hand the carrier to the
        completion drainer and RETURN. The drainer owns fan-out, unlease
        and release, so the lease's lifetime spans the whole chain while
        the scheduler is already stacking the next carrier. No
        carrier-level fault injection — that is member semantics, and the
        engine applies the injector per member."""
        try:
            devices = self._lease(carrier)
        except RequeueTask:
            self._release(carrier)
            if not self._stop.is_set():
                self._requeue(carrier)   # whole group, once, at the front
            return

        tenant_of = {m.uid: _tenant_of(m) for m in batch.members}
        # one shared counter handle per distinct tenant: deliver() runs per
        # member completion, so resolve the registry lookup once up front
        completions_of = {
            label: self.metrics.counter(TENANT_EVENTS, tenant=label,
                                        field="completions")
            for label in set(tenant_of.values()) if label is not None}

        def deliver(c: TaskCompletion) -> None:
            if batch.plan is not None:
                # postmortem perf debugging: every member's journal record
                # carries the carrier's chosen plan and tenant mix
                c.plan = batch.plan
            with self._fusion_lock:
                batch.pending.discard(c.uid)
            counter = completions_of.get(tenant_of.get(c.uid))
            if counter is not None:
                counter.inc()
            self._deliver(c)

        mesh_devices = None
        if batch.mesh_shards:
            # an oversubscribed pool can lease the same place twice; a mesh
            # needs distinct places — when the lease collapses short, run
            # the carrier on the single-device path
            uniq = list(dict.fromkeys(devices))
            if len(uniq) >= batch.mesh_shards:
                mesh_devices = uniq[:batch.mesh_shards]
        cls = (fusion_engine.DagExecution if batch.dag
               else fusion_engine.ChainExecution)
        exe = cls(batch.links, devices, cancel_event, deliver,
                  canceled=self._fused_canceled,
                  fault_injector=self.fault_injector, compose=batch.compose,
                  mesh_devices=mesh_devices)
        # exe.tier is what will ACTUALLY run ("shard" only when the lease
        # made a real mesh), unlike the plan's mesh_shards hint
        self.metrics.counter(CARRIERS_TOTAL, tier=exe.tier).inc()
        # registered BEFORE the dispatches run so the drainer can fan out
        # early links of a chain while a later link is still dispatching
        # (mid-chain journal records exist the moment a link resolves)
        self._drain_q.put((carrier, batch, exe))
        with tel.span("carrier.dispatch", "rts",
                      carrier=carrier.name, tier=exe.tier,
                      links=len(batch.links),
                      width=max(len(link) for link in batch.links),
                      members=len(batch.members),
                      mesh_shards=batch.mesh_shards,
                      tenants=",".join(sorted(
                          str(t) for t in set(tenant_of.values())
                          if t is not None))):
            exe.dispatch()

    def _record_breaker(self, batch: _FusedBatch, exe: Any, ok: bool) -> None:
        """Feed one carrier outcome to the breaker board under the tier it
        ran ("dag-shard" records as "dag": the composition is what the
        consult gated). Never raises: breaker accounting must not disturb
        the drainer's unconditional lease release."""
        try:
            tier = getattr(exe, "tier", None)
            if tier is None or not batch.members:
                return
            tier = {"dag-shard": "dag"}.get(tier, tier)
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
