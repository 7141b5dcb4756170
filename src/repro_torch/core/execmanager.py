"""ExecManager: the workload-management component (paper §II-B.2/3).

Subcomponents (threads):

* **Rmgr** — acquires/releases resources (starts the pilot) via the RTS.
* **Emgr** — pulls tasks from the ``pending`` queue into a submission
  backlog and translates them into RTS submissions. Submission is
  **slot-aware**: each round asks the RTS for its free-slot count
  (:meth:`~repro.rts.base.RTS.free_slots`) and packs the backlog into the
  available capacity with largest-fit backfill keyed on ``task.slots``, so
  wide tasks stop head-of-line-blocking narrow ones and the RTS queue never
  balloons. A starvation guard falls back to strict FIFO draining when the
  backlog head has been passed over too often, so no task waits forever.
  The loop is event-driven: it blocks on the pending queue and is kicked
  awake by completions (slots freed), pilot resizes and RTS restarts.
* **RTSCallback** — receives completion events from the RTS and pushes them
  onto the ``done`` queue (and kicks the Emgr: capacity changed).
* **Heartbeat** — probes RTS liveness; on failure the AppManager tears the
  RTS down, starts a fresh instance and resubmits exactly the lost in-flight
  tasks (black-box RTS fault tolerance, §II-B.4).
* **Watchdog** (beyond paper; required at 10³+ nodes) — straggler
  mitigation via speculative re-execution: a task that exceeds
  ``straggler_factor ×`` its expected duration is cloned; the first attempt
  to finish wins, the loser is canceled and its completion deduplicated.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import traceback
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from .. import telemetry as tel
from . import states as st
from .broker import Broker
from .profiler import ENTK_MANAGEMENT, RTS_OVERHEAD, RTS_TEARDOWN, Profiler
from .pst import Task, WorkflowIndex, resolve_executable
from .state_service import StateService
from .wfprocessor import DONE_QUEUE, PENDING_QUEUE
from ..rts.base import RTS, ResourceDescription, TaskCompletion

#: Task.tags keys of a fused-chain link / fused-DAG node (literals: the core
#: never imports the fusion package; the api compiler stamps them, the
#: JaxRTS consumes them).
CHAIN_TAG = "_fusion_chain"
DAG_TAG = "_fusion_dag"


def _flow_tag(task: Task) -> Optional[dict]:
    """The task's chain OR DAG tag (a task is on at most one flow). Both
    carry ``c``/``k``/``m`` and an ``ss`` superstage extent; a DAG tag
    additionally carries ``w`` (its node's full width), which is what the
    readiness rule keys on."""
    tag = task.tags.get(CHAIN_TAG)
    if tag is None:
        tag = task.tags.get(DAG_TAG)
    return tag if isinstance(tag, dict) else None


class _Lane:
    """One tenant's private slice of the submission backlog (fair share).

    Everything the single-tenant packer keeps as instance state that must
    not leak between tenants lives here: the width buckets, the starvation
    guard's skip count, and the chain-hold bookkeeping (``_chain_ready_locked``
    clears the released set when a lane holds no chains — per-lane state
    keeps one tenant's chain-free round from wiping another's valve
    release). ``deficit`` is the weighted deficit-round-robin credit in
    MEMBERS; an atomic whole-group drain may overdraw it, and the debt
    carries — the oversized-packet rule that stops a 1M-member sweep from
    starving interactive tenants."""

    __slots__ = ("backlog", "head_skips", "has_chain_backlog",
                 "chain_released", "deficit")

    def __init__(self) -> None:
        self.backlog: Dict[int, Deque] = {}
        self.head_skips = 0
        self.has_chain_backlog = False
        self.chain_released: set = set()
        self.deficit = 0.0


class ExecManager:
    def __init__(
        self,
        broker: Broker,
        svc: StateService,
        prof: Profiler,
        rts_factory: Callable[[], RTS],
        resources: ResourceDescription,
        index: WorkflowIndex,
        heartbeat_interval: float = 0.5,
        max_rts_restarts: int = 3,
        straggler_factor: float = 0.0,  # 0 disables speculation
        straggler_min_seconds: float = 1.0,
        speculation_min_samples: int = 64,
        starvation_limit: int = 8,
    ) -> None:
        self.broker = broker
        self.svc = svc
        self.prof = prof
        self.rts_factory = rts_factory
        self.resources = resources
        self.index = index
        self.heartbeat_interval = heartbeat_interval
        self.max_rts_restarts = max_rts_restarts
        self.straggler_factor = straggler_factor
        self.straggler_min_seconds = straggler_min_seconds
        # quantile-driven speculation (ROADMAP 4c): once a kernel has this
        # many dispatch-latency samples, the watchdog thresholds at
        # p99 × straggler_factor instead of the fixed duration_hint
        self.speculation_min_samples = speculation_min_samples
        self.starvation_limit = starvation_limit

        self.rts: Optional[RTS] = None
        self.rts_restarts = 0
        self._submitted: Dict[str, Task] = {}   # uid -> task, in RTS custody
        # Submission backlog: pulled from the pending queue, awaiting free
        # slots. Lives on the instance (not the loop) so an Emgr-thread crash
        # + restart does not strand tasks. Stored as width buckets (one FIFO
        # deque of (seq, task) per task.slots value) so each submit round
        # costs O(batch + distinct widths), not O(backlog log backlog).
        self._backlog: Dict[int, Deque] = {}
        self._backlog_uids: set = set()
        self._backlog_seq = itertools.count()
        self._head_skips = 0                    # rounds the head was passed over
        # chain fusion (see _chain_ready_locked): a chain link may only be
        # submitted once its member's terminal link is visible, so the RTS
        # always receives whole member chains and orders the links itself
        self._has_chain_backlog = False
        self._chain_holding = False
        self._chain_held_ids: set = set()
        self._chain_released: set = set()
        self._chain_stalls = 0
        # Fair share (serving mode, opt-in via set_fair_share): tasks are
        # bucketed into per-tenant lanes keyed on tags["_tenant"] and packed
        # by weighted deficit-round-robin; None keeps the classic
        # single-backlog path byte-identical.
        self._fair_policy = None
        self._lanes: Dict[str, _Lane] = {}
        self._lane_cursor = 0
        self.fair_quantum = 256     # DRR credit (members) per visit per weight
        self._picked_slots = 0      # slots charged by the last pick round
        self._spec_of: Dict[str, str] = {}      # clone uid -> original uid
        self._spec_for: Dict[str, str] = {}     # original uid -> clone uid
        self._speculated: set = set()           # originals already cloned
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._emgr_thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._wd_thread: Optional[threading.Thread] = None
        self.emgr_crash_hook: Optional[Callable[[], None]] = None
        self.component_errors: List[str] = []
        self.speculations = 0
        self.speculation_wins = 0
        self.speculations_from_quantile = 0   # thresholded at measured p99
        self.speculations_from_hint = 0       # cold-start duration_hint path
        self._kernel_cache: Dict = {}         # payload key -> telemetry label
        # Observability for the no-busy-wait tests: wakeups only happen on
        # pending messages or capacity kicks, never on a poll timer.
        self.emgr_wakeups = 0
        self.submit_rounds = 0

    # -- Rmgr ------------------------------------------------------------------#

    def acquire_resources(self) -> None:
        with self.prof.measure(RTS_OVERHEAD):
            self.rts = self.rts_factory()
            self.rts.set_callback(self._rts_callback)
            if hasattr(self.rts, "set_capacity_callback"):
                # federation: member re-admission announces new capacity so
                # the backlog re-evaluates without polling
                self.rts.set_capacity_callback(self._on_capacity_change)
            pilot = self.rts.start(self.resources)
            # Record granted-not-requested: a backend may clamp (JaxRTS:
            # device inventory; federation: aggregate of member grants) and
            # reports the granted count through the pilot description instead
            # of mutating the caller's ResourceDescription in place.
            granted = getattr(getattr(pilot, "description", None), "slots",
                              None)
            if isinstance(granted, int) and granted > 0:
                self.resources.slots = granted

    def _on_capacity_change(self) -> None:
        # same contract as the completion kick: only wake the Emgr when it
        # actually holds tasks back for capacity (_backlog_uids spans the
        # classic backlog AND the fair-share tenant lanes)
        if self._backlog_uids:
            self.broker.kick(PENDING_QUEUE)

    def release_resources(self) -> None:
        if self.rts is not None:
            with self.prof.measure(RTS_TEARDOWN):
                self.rts.stop()

    def resize(self, slots: int) -> None:
        """Elastic scaling passthrough; wakes the Emgr (capacity changed).
        ``resources.slots`` records what the RTS actually granted — a
        backend may clamp (JaxRTS: device inventory), and an unclamped
        value here would break the Emgr's pilot-idle starvation escape."""
        if self.rts is not None:
            self.resources.slots = self.rts.resize(slots)
            self.broker.kick(PENDING_QUEUE)

    # -- lifecycle ----------------------------------------------------------#

    def start(self) -> None:
        self._stop.clear()
        self.start_emgr()
        self.start_heartbeat()
        if self.straggler_factor > 0:
            self.start_watchdog()

    def start_emgr(self) -> None:
        self._emgr_thread = threading.Thread(
            target=self._guarded, args=(self._emgr_loop, "emgr"),
            daemon=True, name="em-emgr")
        self._emgr_thread.start()

    def start_heartbeat(self) -> None:
        self._hb_thread = threading.Thread(
            target=self._guarded, args=(self._heartbeat_loop, "heartbeat"),
            daemon=True, name="em-heartbeat")
        self._hb_thread.start()

    def start_watchdog(self) -> None:
        self._wd_thread = threading.Thread(
            target=self._guarded, args=(self._watchdog_loop, "watchdog"),
            daemon=True, name="em-watchdog")
        self._wd_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.broker.kick(PENDING_QUEUE)
        for t in (self._emgr_thread, self._hb_thread, self._wd_thread):
            if t is not None:
                t.join(timeout=5.0)
        self._emgr_thread = self._hb_thread = self._wd_thread = None
        self.release_resources()

    def threads_alive(self) -> Dict[str, bool]:
        """Liveness of every ExecManager thread, so the AppManager's
        component-restart logic can observe (and heal) any of them dying."""
        alive = {
            "emgr": bool(self._emgr_thread and self._emgr_thread.is_alive()),
            "heartbeat": bool(self._hb_thread and self._hb_thread.is_alive()),
        }
        if self.straggler_factor > 0:
            alive["watchdog"] = bool(self._wd_thread
                                     and self._wd_thread.is_alive())
        return alive

    def _guarded(self, fn: Callable[[], None], name: str) -> None:
        try:
            fn()
        except Exception:  # noqa: BLE001
            self.component_errors.append(
                f"{name}: {traceback.format_exc(limit=5)}")

    # -- Emgr ------------------------------------------------------------------#

    def _emgr_loop(self) -> None:
        while not self._stop.is_set():
            msgs = self.broker.get_many(PENDING_QUEUE, 128, timeout=None,
                                        abort=self._stop)
            if self._stop.is_set():
                return
            if self.emgr_crash_hook is not None:
                self.emgr_crash_hook()
            self.emgr_wakeups += 1
            if msgs:
                t0 = time.perf_counter()
                with self._lock:
                    for tag, uid in msgs:
                        task = self.index.task(uid)
                        # SUBMITTING is advanced at submission time (one
                        # coalesced SUBMITTING→SUBMITTED hop per task);
                        # backlogged tasks stay SCHEDULED
                        if (task is not None and not task.is_final
                                and uid not in self._backlog_uids
                                and uid not in self._submitted):
                            if self._fair_policy is not None:
                                lane = self._lane_for(task)
                                lane.backlog.setdefault(
                                    task.slots, deque()).append(
                                        (next(self._backlog_seq), task))
                                self._backlog_uids.add(uid)
                                if (CHAIN_TAG in task.tags
                                        or DAG_TAG in task.tags):
                                    lane.has_chain_backlog = True
                                continue
                            self._backlog.setdefault(
                                task.slots, deque()).append(
                                    (next(self._backlog_seq), task))
                            self._backlog_uids.add(uid)
                            if (CHAIN_TAG in task.tags
                                    or DAG_TAG in task.tags):
                                # arms the whole-chain/DAG hand-off
                                # machinery; flow-free workloads never pay
                                # its scan
                                self._has_chain_backlog = True
                self.broker.ack_many(PENDING_QUEUE, [t for t, _ in msgs])
                self.prof.add(ENTK_MANAGEMENT, time.perf_counter() - t0)
            # quiescent = a kick-only wakeup: while pending messages are
            # still streaming in, a held chain is simply incomplete, not
            # stalled — only kick wakeups may advance the anti-stall valve
            self._submit_ready(quiescent=not msgs)

    def _submit_ready(self, quiescent: bool = True) -> None:
        """Pack backlog tasks into the RTS's free slots and submit them.

        Against a federated RTS (one exposing :meth:`member_slots`) the
        packer is placement-aware: largest-fit backfill *within* each member,
        least-loaded spill *across* members, hard ``task.backend`` affinity,
        and the starvation guard preserved federation-wide. Each placed task
        carries its member in ``task.tags['_fed_member']`` so the federation
        routes it without re-deciding."""
        rts = self.rts
        if rts is None:
            return
        try:
            fusion = rts.supports_fusion()
        except Exception:  # noqa: BLE001 - dying RTS: heartbeat handles it
            fusion = False
        member_slots = getattr(rts, "member_slots", None)
        if member_slots is not None:
            try:
                slots_map = member_slots()
            except Exception:  # noqa: BLE001 - dying RTS: heartbeat handles it
                return
            known = getattr(rts, "member_names", lambda: list(slots_map))()
            # whole-group pinning is only sound on members that actually
            # batch fused groups; a federation names them, a plain RTS that
            # supports fusion batches everywhere it places
            fuse_members = getattr(rts, "fusion_members", None)
            fusing = (set(fuse_members()) if fuse_members is not None
                      else (set(known) if fusion else set()))
            with self._lock:
                if self._fair_policy is not None:
                    # fair share + federation is not packed per-tenant this
                    # release: the lanes fold back into the classic backlog
                    # and the placement-aware packer runs as before
                    self._merge_lanes_locked()
                placements = self._pick_batch_federated_locked(
                    slots_map, set(known), fusing=fusing)
                batch = []
                for name, task in placements:
                    task.tags["_fed_member"] = name
                    self._submitted[task.uid] = task
                    batch.append(task)
        else:
            try:
                free = rts.free_slots()
            except Exception:  # noqa: BLE001 - dying RTS: heartbeat handles it
                return
            with self._lock:
                if self._fair_policy is not None:
                    batch = self._pick_batch_fair_locked(free, fusion=fusion)
                else:
                    batch = self._pick_batch_locked(free, fusion=fusion)
                for task in batch:
                    self._submitted[task.uid] = task
                self._chain_valve_locked(bool(batch), quiescent)
        if not batch:
            return
        self.submit_rounds += 1
        t1 = time.perf_counter()
        # SUBMITTED before the actual hand-off: an instantly-completing task
        # must never race its DONE transition past SUBMITTING. If submit()
        # fails, the heartbeat restart path resubmits from self._submitted.
        # The advance chain runs under self._lock: AppManager.cancel takes
        # the same lock, so a concurrent CANCELED can never interleave with
        # (or be overwritten by) the SUBMITTING→SUBMITTED hops.
        now = time.time()
        sink: List = []
        submittable: List[Task] = []
        with self._lock:
            for task in batch:
                try:
                    self.svc.advance_seq(task, (st.SUBMITTING, st.SUBMITTED),
                                         transact=False, sink=sink)
                except Exception:  # noqa: BLE001 - canceled concurrently
                    self._submitted.pop(task.uid, None)
                    continue
                task.submitted_at = now
                submittable.append(task)
        self.svc.flush(sink)  # publish before the RTS can complete anything
        if not submittable:
            return
        with tel.span("emgr.submit", "emgr", tasks=len(submittable)):
            rts.submit(submittable)
        tel.counter("emgr_submit_rounds_total").inc()
        tel.counter("emgr_submitted_tasks_total").inc(len(submittable))
        self.prof.add(RTS_OVERHEAD, time.perf_counter() - t1)

    def _prune_fronts_locked(self) -> None:
        """Drop finalized (e.g. canceled-while-waiting) tasks from bucket
        fronts and delete empty buckets; interior finals are skipped lazily
        when the backfill reaches them."""
        for width in list(self._backlog):
            dq = self._backlog[width]
            while dq and dq[0][1].is_final:
                _, stale = dq.popleft()
                self._backlog_uids.discard(stale.uid)
            if not dq:
                del self._backlog[width]

    def _pop_head_locked(self, head: Task) -> None:
        """Remove ``head`` from the front of its width bucket (it is always
        a bucket front: heads are picked from fronts only)."""
        dq = self._backlog[head.slots]
        dq.popleft()
        if not dq:
            del self._backlog[head.slots]
        self._backlog_uids.discard(head.uid)

    def _head_locked(self) -> Optional[Task]:
        """The globally oldest live backlog task (min seq over fronts)."""
        best = None
        for dq in self._backlog.values():
            seq, task = dq[0]
            if best is None or seq < best[0]:
                best = (seq, task)
        return best[1] if best else None

    # -- whole-chain hand-off (chain fusion) ----------------------------------#

    def _chain_ready_locked(self) -> Optional[set]:
        """Chain ids whose backlog fragment is submittable as one piece.

        The superstage scheduler hands a chain's stages off in one batched
        pending publish, but the broker delivers it in bounded chunks — so
        a pack round can see link 0 of members whose links 1..L-1 are
        still in the queue. Submitting such a fragment would hand the RTS
        a downstream link later, mid-flight, racing the result-store
        routing of its inputs. The rule: a chain is held until EVERY
        member present in the backlog has its *fragment-terminal* link —
        the highest link the superstage co-published, stamped as ``ss`` on
        the tag — there too (FIFO delivery then guarantees all the links
        in between as well), at which point the whole-chain drain submits
        every member's full link range in one ``rts.submit``, and the RTS
        owns the ordering. Tasks without an ``ss`` stamp were never
        co-published (mixed stage, federation, gated continuation): their
        stages flow one at a time, so they are never held. Returns None
        when the backlog holds no chain (chain-free workloads skip the
        scan entirely).
        """
        if not self._has_chain_backlog:
            return None
        seen: set = set()
        waiting: Dict[str, set] = {}
        arrived: Dict[str, set] = {}
        dag_ids: set = set()
        dag_width: Dict[str, int] = {}   # DAG id -> terminal node width
        for dq in self._backlog.values():
            for _, task in dq:
                tag = _flow_tag(task)
                if tag is None:
                    continue
                c = tag.get("c")
                seen.add(c)
                if "w" in tag:
                    dag_ids.add(c)
                ss = tag.get("ss")
                if not isinstance(ss, int):
                    continue  # never co-published: nothing to wait for
                if tag.get("k") == ss:
                    arrived.setdefault(c, set()).add(tag.get("m"))
                    if isinstance(tag.get("w"), int):
                        dag_width[c] = tag["w"]
                else:
                    waiting.setdefault(c, set()).add(tag.get("m"))
        if not seen:
            # the last chain drained: stop paying the scan until the next
            # chain-tagged task enters the backlog
            self._has_chain_backlog = False
            self._chain_released.clear()
            return None
        # a valve release is one-shot: it covers exactly the stuck fragment
        # that tripped it — once that fragment leaves the backlog, later
        # fragments of the same chain get the normal hold + custody veto
        # again (and the set cannot grow across adaptive rounds)
        self._chain_released &= seen
        # custody veto: while ANY link of a chain is submitted-but-
        # unfinished, later fragments of that chain (a retried member, a
        # straggling broker chunk) must wait — submitting them would race
        # the in-flight links' result routing exactly like a split fragment
        busy = set()
        for task in self._submitted.values():
            tag = _flow_tag(task)
            if tag is not None:
                busy.add(tag.get("c"))
        ready = set()
        for c in set(waiting) | set(arrived):
            if c in busy:
                continue
            if c in dag_ids:
                # count-based rule for DAGs: node widths change across a
                # fan-in (k members -> 1 reducer -> k members), so the
                # chains' member-subset rule cannot transfer. The whole
                # TERMINAL node being in the backlog implies — by FIFO
                # delivery of the superstage's single batched publish —
                # that every earlier node's task arrived too.
                if len(arrived.get(c, ())) >= dag_width.get(c, 1 << 30):
                    ready.add(c)
            elif waiting.get(c, set()) <= arrived.get(c, set()):
                ready.add(c)
        return ready

    def _chain_held_locked(self, task: Task, chain_ready: set) -> bool:
        tag = _flow_tag(task)
        if tag is None:
            return False
        if not isinstance(tag.get("ss"), int):
            return False  # never superstaged: stage gating orders it
        cid = tag.get("c")
        if cid in chain_ready or cid in self._chain_released:
            return False
        self._chain_holding = True
        self._chain_held_ids.add(cid)
        return True

    def _take_locked(self, width: int, batch: List[Task],
                     remaining: int, fusion: bool = False,
                     chain_ready: Optional[set] = None) -> int:
        """Move fitting live tasks of one width bucket into ``batch``.

        Against a fusion-capable RTS, taking a task that carries a
        ``_fusion_group`` tag drains every *consecutive* same-group task in
        the bucket along with it, charging the group's slots ONCE: the RTS
        executes the whole group as batched dispatches on one member-width
        device lease, so per-member slot accounting here would throttle
        submission to scalar speed — the opposite of what fusion buys.
        A ``_fusion_chain`` link additionally drains its whole chain (every
        link's group, one charge) and is held back while its member's
        chain is still incomplete (see :meth:`_chain_ready_locked`).
        A group the RTS plans to execute as an SPMD *mesh* dispatch is
        charged the whole mesh instead (:meth:`RTS.planned_group_slots`) —
        one sharded carrier really does occupy every mesh device.
        """
        dq = self._backlog.get(width)
        while dq and width <= remaining:
            _, task = dq[0]
            if task.is_final:
                dq.popleft()
                self._backlog_uids.discard(task.uid)
                continue  # lazily pruned
            if (chain_ready is not None
                    and self._chain_held_locked(task, chain_ready)):
                break  # strict FIFO within the width: hold the bucket here
            dq.popleft()
            self._backlog_uids.discard(task.uid)
            batch.append(task)
            remaining -= width
            if fusion:
                before = len(batch)
                self._drain_group_locked(dq, task, batch.append)
                remaining -= self._group_surcharge(
                    1 + len(batch) - before, width)
        if dq is not None and not dq:
            del self._backlog[width]
        return remaining

    def _group_surcharge(self, n_members: int, width: int) -> int:
        """Slots beyond the historical one-member charge for a drained
        fused group: a sharded carrier leases the whole mesh, so the
        packer must not backfill other work into those slots."""
        if n_members < 2 or self.rts is None:
            return 0
        try:
            planned = int(self.rts.planned_group_slots(n_members, width))
        except Exception:  # noqa: BLE001 - advisory hook only
            return 0
        return max(0, planned - width)

    def _drain_group_locked(self, dq: Optional[Deque], first: Task,
                            take: Callable[[Task], None]) -> None:
        """Pop every consecutive task sharing ``first``'s fusion group —
        or, for a chain link, EVERY task of ``first``'s chain anywhere in
        the bucket — into ``take`` (lazily pruning finals) WITHOUT
        charging slots: the run rides the batched dispatches its first
        member already paid for.

        The chain drain deliberately ignores adjacency: two chains' (or a
        chain's and other work's) tasks may interleave in one bucket, and
        leaving a ready chain's tail behind would submit it as a separate
        fragment in a later round — racing the links already in flight.
        Non-chain tasks keep their relative FIFO order.
        """
        group = first.tags.get("_fusion_group")
        ftag = _flow_tag(first)
        chain = ftag.get("c") if ftag is not None else None
        if chain is not None:
            if not dq:
                return
            kept: Deque = deque()
            while dq:
                entry = dq.popleft()
                _, nxt = entry
                if nxt.is_final:
                    self._backlog_uids.discard(nxt.uid)
                    continue
                ntag = _flow_tag(nxt)
                if ntag is not None and ntag.get("c") == chain:
                    self._backlog_uids.discard(nxt.uid)
                    take(nxt)
                else:
                    kept.append(entry)
            dq.extend(kept)
            return
        if group is None:
            return
        while dq:
            _, nxt = dq[0]
            if nxt.is_final:
                dq.popleft()
                self._backlog_uids.discard(nxt.uid)
                continue
            ntag = _flow_tag(nxt)
            if ntag is not None or nxt.tags.get("_fusion_group") != group:
                return
            dq.popleft()
            self._backlog_uids.discard(nxt.uid)
            take(nxt)

    def _pick_batch_locked(self, free: Optional[int],
                           fusion: bool = False) -> List[Task]:
        """Largest-fit backfill of the backlog into ``free`` slots.

        ``free is None`` means the RTS does not report capacity (e.g. the
        SimulatedRTS's virtual clock makes wallclock capacity meaningless):
        drain the backlog FIFO, as the pre-slot-aware Emgr did.

        Fairness: if the FIFO head was passed over ``starvation_limit``
        times, it is placed FIRST on the round it fits, and while it does
        not fit nothing younger may jump it (conservative backfill). A head
        wider than the whole idle pilot is submitted anyway — the RTS, not
        the Emgr, owns that error.
        """
        self._prune_fronts_locked()
        self._chain_holding = False
        self._chain_held_ids = set()
        self._picked_slots = 0
        if not self._backlog:
            return []
        if free is None:
            # full FIFO drain: merge the width buckets back into seq order
            merged = heapq.merge(*self._backlog.values())
            batch = [task for _, task in merged if not task.is_final]
            self._backlog.clear()
            self._backlog_uids.clear()
            return batch
        chain_ready = self._chain_ready_locked() if fusion else None
        head = self._head_locked()
        if head is None:
            return []
        batch: List[Task] = []
        remaining = free
        if head.slots > free:
            pilot_idle = free >= max(1, self.resources.slots)
            if pilot_idle and not self._submitted:
                # the head can never fit: hand it over, let the RTS decide
                self._pop_head_locked(head)
                self._head_skips = 0
                self._picked_slots = free
                return [head]
            if self._head_skips >= self.starvation_limit:
                return []  # hold everything: drain until the head fits
        elif self._head_skips >= self.starvation_limit:
            if (chain_ready is not None
                    and self._chain_held_locked(head, chain_ready)):
                # a held chain link is starved by design: its missing links
                # are seconds (or one valve trip) away — never force a
                # partial chain past the hold
                return []
            # starved head goes first, then backfill with what still fits
            self._pop_head_locked(head)
            batch.append(head)
            remaining -= head.slots
            self._head_skips = 0
            if fusion:
                before = len(batch)
                self._drain_group_locked(
                    self._backlog.get(head.slots), head, batch.append)
                remaining -= self._group_surcharge(
                    1 + len(batch) - before, head.slots)
        for width in sorted(self._backlog, reverse=True):
            if remaining <= 0:
                break
            remaining = self._take_locked(width, batch, remaining,
                                          fusion=fusion,
                                          chain_ready=chain_ready)
        if not batch:
            return []
        self._picked_slots = free - remaining   # slot charge (group-aware)
        if any(t.uid == head.uid for t in batch):
            self._head_skips = 0
        else:
            self._head_skips += 1
        return batch

    # -- fair share (serving mode) ---------------------------------------------#

    def set_fair_share(self, policy) -> None:
        """Install a weighted fair-share policy (duck-typed: anything with
        ``weight(tenant) -> float``; see ``repro.serve.fair_share``). The
        backlog then packs tenants by deficit-round-robin; ``None`` restores
        the classic single-backlog packer."""
        with self._lock:
            self._fair_policy = policy
            if policy is not None and self._backlog:
                # migrate anything already backlogged into its tenant's lane
                for dq in self._backlog.values():
                    for seq, task in dq:
                        lane = self._lane_for(task)
                        lane.backlog.setdefault(task.slots, deque()).append(
                            (seq, task))
                        if CHAIN_TAG in task.tags or DAG_TAG in task.tags:
                            lane.has_chain_backlog = True
                self._backlog = {}
            elif policy is None and self._lanes:
                self._merge_lanes_locked()

    def _lane_for(self, task: Task) -> _Lane:
        # untagged tasks (dynamic stages minted mid-run, non-serve
        # submissions) lane by workflow namespace so they still round-robin
        # fairly rather than pooling into one anonymous lane
        tenant = str(task.tags.get("_tenant")
                     or task.tags.get("_wf_ns") or "")
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = self._lanes[tenant] = _Lane()
        return lane

    def _merge_lanes_locked(self) -> None:
        """Fold every tenant lane back into the classic backlog in seq
        order (federated fallback / fair share switched off)."""
        entries = [e for lane in self._lanes.values()
                   for dq in lane.backlog.values() for e in dq]
        for lane in self._lanes.values():
            lane.backlog.clear()
            lane.has_chain_backlog = False
        for seq, task in sorted(entries):
            self._backlog.setdefault(task.slots, deque()).append((seq, task))
            if CHAIN_TAG in task.tags or DAG_TAG in task.tags:
                self._has_chain_backlog = True

    def _pick_batch_fair_locked(self, free: Optional[int],
                                fusion: bool = False) -> List[Task]:
        """Weighted deficit-round-robin over the tenant lanes.

        Each lane visit grants ``fair_quantum × weight`` members of credit,
        then runs the UNCHANGED single-tenant packer against that lane's
        private backlog (its width buckets, starvation guard and chain-hold
        state context-swapped in), charging the members actually taken.
        An atomic whole-group drain may overdraw; the debt carries and the
        lane sits out rounds until repaid — so one tenant's huge sweep
        interleaves with, rather than starves, everyone else. Because the
        per-round batch spans several lanes, same-group members from
        different tenants reach ``rts.submit`` together and pack into the
        same carriers.
        """
        if free is None:
            # capacity-blind RTS: drain every lane merged back to seq order
            merged = heapq.merge(*(dq for lane in self._lanes.values()
                                   for dq in lane.backlog.values()))
            batch = []
            for _, task in merged:
                self._backlog_uids.discard(task.uid)
                if not task.is_final:
                    batch.append(task)
            for lane in self._lanes.values():
                lane.backlog.clear()
                lane.has_chain_backlog = False
            self._chain_holding = False
            self._chain_held_ids = set()
            return batch
        tenants = list(self._lanes)
        n = len(tenants)
        merged_holding = False
        merged_held: set = set()
        batch: List[Task] = []
        remaining = free
        start = self._lane_cursor % n if n else 0
        # two sweeps: the first grants quanta, the second lets lanes later
        # in the rotation use slots earlier lanes left idle this round
        for i in range(2 * n):
            if remaining <= 0:
                break
            lane = self._lanes[tenants[(start + i) % n]]
            if not lane.backlog:
                # classic DRR: an empty lane forfeits unused credit (debt
                # from an oversized drain is kept so a resubmitting heavy
                # tenant cannot burst past its share)
                lane.deficit = min(lane.deficit, 0.0)
                continue
            if i < n:
                lane.deficit += (self.fair_quantum
                                 * self._fair_policy.weight(tenants[(start + i) % n]))
            if lane.deficit <= 0:
                continue   # still repaying an oversized group drain
            # context swap: the single-tenant packer runs on this lane
            self._backlog = lane.backlog
            self._head_skips = lane.head_skips
            self._has_chain_backlog = lane.has_chain_backlog
            self._chain_released = lane.chain_released
            picked = self._pick_batch_locked(remaining, fusion=fusion)
            lane.head_skips = self._head_skips
            lane.has_chain_backlog = self._has_chain_backlog
            lane.chain_released = self._chain_released
            merged_holding = merged_holding or self._chain_holding
            merged_held |= self._chain_held_ids
            if picked:
                batch.extend(picked)
                lane.deficit -= len(picked)
                remaining -= min(remaining, self._picked_slots)
                tel.counter("emgr_fair_grants_total",
                            tenant=tenants[(start + i) % n]).inc()
                tel.counter("emgr_fair_granted_tasks_total",
                            tenant=tenants[(start + i) % n]).inc(len(picked))
        if n:
            self._lane_cursor = (start + 1) % n
        self._backlog = {}
        self._chain_released = set()
        self._chain_holding = merged_holding
        self._chain_held_ids = merged_held
        return batch

    def _pick_batch_federated_locked(
            self, slots_map: Dict[str, "tuple[int, int]"],
            known: set,
            fusing: Optional[set] = None) -> List["tuple[str, Task]"]:
        """Placement-aware backfill over a federation's members.

        ``slots_map``: ``{member: (free, total)}`` for *active* members;
        ``known``: every member name, active or quarantined. Returns
        ``(member, task)`` placements.

        Policy: hard ``task.backend`` affinity (a task pinned to a
        quarantined member is *parked* — skipped without blocking its width
        bucket or the starvation guard; a task pinned to a member the
        federation has never heard of is forwarded anyway so the RTS can
        reject it, mirroring the wide-head hand-over); otherwise largest-fit
        backfill with least-loaded spill (most-free member that fits). The
        starvation guard is federation-wide: the oldest placeable task is
        the guard's head exactly as in the single-member packer.
        """
        self._prune_fronts_locked()
        if not self._backlog:
            return []
        free = {n: f for n, (f, _t) in slots_map.items()}
        totals = {n: t for n, (_f, t) in slots_map.items()}
        placements: List["tuple[str, Task]"] = []

        def eligible(task: Task) -> Optional[List[str]]:
            """Members the task may run on; None ⇒ parked (member exists
            but is quarantined); [] ⇒ unknown member, forward-and-reject."""
            if task.backend is None:
                return list(free)
            if task.backend in free:
                return [task.backend]
            return None if task.backend in known else []

        def try_place(task: Task,
                      pin: Optional[str] = None) -> "tuple[str, Optional[str]]":
            """Place one task; returns (status, member). ``pin`` places on
            that member without charging its free count — used to keep a
            fusible group's members together on the member that already
            charged for the group's single batched dispatch."""
            if pin is not None:
                placements.append((pin, task))
                return "placed", pin
            names = eligible(task)
            if names is None:
                return "park", None
            if not names and task.backend is not None:
                placements.append((task.backend, task))
                return "placed", task.backend  # unknown: the RTS owns the error
            fits = [n for n in names if free[n] >= task.slots]
            if not fits:
                return "full", None
            pick = max(fits, key=lambda n: free[n])
            free[pick] -= task.slots
            placements.append((pick, task))
            return "placed", pick

        # federation-wide starvation head: oldest bucket-front that is not
        # parked (a parked task cannot make progress, so it must not hold
        # the rest of the fleet hostage through the guard)
        head = None
        for dq in self._backlog.values():
            seq, task = dq[0]
            if (task.backend is not None and task.backend not in free
                    and task.backend in known):
                continue
            if head is None or seq < head[0]:
                head = (seq, task)
        if head is not None:
            htask = head[1]
            elig = eligible(htask) or []
            fits_now = (htask.backend is not None
                        and htask.backend not in known) or any(
                            free[n] >= htask.slots for n in elig)
            if not fits_now:
                cap = [totals[n] for n in elig] or [0]
                fed_idle = sum(free.values()) >= max(1, sum(totals.values()))
                if (htask.slots > max(cap) and fed_idle
                        and not self._submitted):
                    # the head can never fit any member: hand it to the
                    # largest eligible pilot, the RTS owns that error
                    self._pop_head_locked(htask)
                    self._head_skips = 0
                    target = max(elig, key=lambda n: totals[n]) if elig \
                        else htask.backend
                    return [(target, htask)]
                if self._head_skips >= self.starvation_limit:
                    return []  # hold everything: drain until the head fits
            elif self._head_skips >= self.starvation_limit:
                # starved head goes first, then backfill with what still fits
                self._pop_head_locked(htask)
                try_place(htask)
                self._head_skips = 0
        for width in sorted(self._backlog, reverse=True):
            self._take_federated_locked(width, try_place,
                                        fusing=fusing or set())
        if not placements:
            return []
        if head is None or any(t.uid == head[1].uid for _, t in placements):
            self._head_skips = 0
        else:
            self._head_skips += 1
        return placements

    def _take_federated_locked(self, width: int, try_place: Callable,
                               fusing: set) -> None:
        """Scan one width bucket: place what fits, skip over parked tasks,
        stop at the first task that is eligible but out of capacity (strict
        FIFO within a width, exactly like the single-member packer).

        Placing a ``_fusion_group``-tagged task on a member in ``fusing``
        (one whose runtime batches fused groups) pins every consecutive
        same-group task onto that member without charging its free count
        again: the group executes there as one batched dispatch (group
        keys include the backend affinity, so the pin never violates
        placement constraints). A group landing on a *scalar* member is
        never pinned — that pilot runs tasks one by one, so its members
        place and charge individually like any other work."""
        dq = self._backlog.get(width)
        if dq is None:
            return
        kept: Deque = deque()
        while dq:
            seq, task = dq.popleft()
            if task.is_final:
                self._backlog_uids.discard(task.uid)
                continue
            res, member = try_place(task)
            if res == "placed":
                self._backlog_uids.discard(task.uid)
                if member is not None and member in fusing:
                    self._drain_group_locked(
                        dq, task, lambda nxt: try_place(nxt, pin=member))
            elif res == "park":
                kept.append((seq, task))
            else:  # full
                kept.append((seq, task))
                kept.extend(dq)
                dq.clear()
        if kept:
            self._backlog[width] = kept
        else:
            del self._backlog[width]

    def _chain_valve_locked(self, submitted_any: bool,
                            quiescent: bool) -> None:
        """Anti-stall valve for the chain hold: if holds are the ONLY thing
        in the backlog and nothing is in custody for several consecutive
        QUIESCENT rounds (kick-only wakeups — while pending messages still
        stream in, a held chain is merely incomplete), the missing links
        are never coming (e.g. a downstream retry whose sibling exhausted
        its budget) — release the held chains so they run per-stage
        instead of deadlocking the workflow. By the time the valve trips,
        every earlier completion has long been routed, so per-stage
        execution resolves its inputs safely."""
        if submitted_any or not self._chain_holding:
            self._chain_stalls = 0
            return
        if not quiescent or self._submitted:
            return  # messages still flowing / work in flight: not a stall
        self._chain_stalls += 1
        if self._chain_stalls >= 3:
            self._chain_released.update(self._chain_held_ids)
            if self._fair_policy is not None:
                # fair mode: the holds live in per-lane released sets (each
                # lane prunes ids that are not its own on its next scan)
                for lane in self._lanes.values():
                    lane.chain_released.update(self._chain_held_ids)
            self._chain_stalls = 0
            self.broker.kick(PENDING_QUEUE)

    def n_backlogged(self) -> int:
        with self._lock:
            return (sum(len(dq) for dq in self._backlog.values())
                    + sum(len(dq) for lane in self._lanes.values()
                          for dq in lane.backlog.values()))

    # -- RTSCallback -------------------------------------------------------------#

    def _rts_callback(self, c: TaskCompletion) -> None:
        uid = c.uid
        to_cancel: List[str] = []
        with self._lock:
            original = self._spec_of.pop(uid, None)
            if original is not None:
                if c.exit_code != 0 and original in self._submitted:
                    # the speculative clone failed while the original is
                    # still running: drop the clone, keep the original
                    self._spec_for.pop(original, None)
                    return
                # A speculative clone finished first: report it as the
                # original and cancel the still-running original attempt.
                self._spec_for.pop(original, None)
                if c.exit_code == 0:
                    self.speculation_wins += 1
                to_cancel.append(original)  # cancel the slower original
                uid = original
            else:
                clone = self._spec_for.pop(uid, None)
                if clone is not None:
                    # the original finished first: cancel the clone
                    self._spec_of.pop(clone, None)
                    to_cancel.append(clone)
            task = self._submitted.pop(uid, None)
        if to_cancel and self.rts is not None:
            # best-effort: the winner's own uid may be in the list; RTS
            # cancel of an already-finished task is a no-op.
            try:
                self.rts.cancel([u for u in to_cancel if u != c.uid])
            except Exception:  # noqa: BLE001
                pass
        if task is None:
            return  # duplicate completion (losing speculative attempt)
        # No state advance here: this runs on the RTS's own thread, and the
        # Dequeue coalesces EXECUTED into the completion chain. The callback
        # only converts the event into a message.
        self.broker.put(DONE_QUEUE, {
            "uid": uid,
            "exit_code": c.exit_code,
            "result": c.result,
            "exception": c.exception,
            "completed_at": c.completed_at,
            "execution_seconds": c.execution_seconds,
            "staging_seconds": c.staging_seconds,
            "pilot_lost": getattr(c, "pilot_lost", False),
            "plan": getattr(c, "plan", None),
        })
        # capacity freed: wake the Emgr — but only when it actually holds
        # tasks back for slots (unconditional kicks would wake it once per
        # completion for nothing). Racing a concurrent backlog append is
        # benign: the appender's own loop runs _submit_ready afterwards.
        if self._backlog_uids:
            self.broker.kick(PENDING_QUEUE)

    # -- Heartbeat ------------------------------------------------------------#

    def _heartbeat_loop(self) -> None:
        misses = 0
        while not self._stop.is_set():
            self._stop.wait(self.heartbeat_interval)
            if self._stop.is_set():
                return
            try:
                ok = self.rts is not None and self.rts.alive()
            except Exception:  # noqa: BLE001 - a dead RTS may throw anything
                ok = False
            if ok:
                misses = 0
                if self._chain_holding and not self._submitted:
                    # drive the anti-stall valve forward: a held chain with
                    # nothing in flight generates no completion kicks, so
                    # the heartbeat supplies the wakeups the valve counts
                    self.broker.kick(PENDING_QUEUE)
                continue
            misses += 1
            if misses >= 2:
                misses = 0
                self._restart_rts()

    def _restart_rts(self) -> None:
        """Tear down the failed RTS, start a fresh one, resubmit lost tasks."""
        if self.rts_restarts >= self.max_rts_restarts:
            self.component_errors.append(
                "rts: restart budget exhausted")
            self._stop.set()
            self.broker.kick(PENDING_QUEUE)
            return
        self.rts_restarts += 1
        with self._lock:
            lost = list(self._submitted.values())
            self._spec_of.clear()
            self._spec_for.clear()
        try:
            # detach first: the dying instance must not deliver cancellation
            # completions for tasks we are about to resubmit
            self.rts.set_callback(None)
            with self.prof.measure(RTS_TEARDOWN):
                self.rts.stop()   # purge leftovers of the failed instance
        except Exception:  # noqa: BLE001
            pass
        self.acquire_resources()
        if lost:
            t0 = time.perf_counter()
            self.rts.submit(lost)
            self.prof.add(RTS_OVERHEAD, time.perf_counter() - t0)
        # fresh pilot, fresh capacity: let the Emgr re-evaluate its backlog
        self.broker.kick(PENDING_QUEUE)

    # -- Watchdog (straggler speculation) ------------------------------------#

    #: the api layer's trampoline executable (literal: the core never
    #: imports the fusion package; see fusion.engine.TRAMPOLINE)
    _TRAMPOLINE = "reg://_api.call"

    def _task_kernel(self, task: Task) -> Optional[str]:
        """The task's per-kernel telemetry label — the key every dispatch
        path observes DISPATCH_LATENCY under — or None for payloads with no
        kernel identity (``sleep://`` synthetics, unresolvable refs)."""
        if task.executable == self._TRAMPOLINE:
            key = task.kwargs.get("__fn__")
        else:
            key = task._fn if task._fn is not None else task.executable
        try:
            return self._kernel_cache[key]
        except (KeyError, TypeError):
            pass
        try:
            if task.executable == self._TRAMPOLINE:
                fn = resolve_executable(task.kwargs["__fn__"])
            else:
                fn = task.resolve()
            label = getattr(fn, "__name__", None) or str(fn)
        except Exception:  # noqa: BLE001 - no callable: no kernel label
            label = None
        try:
            self._kernel_cache[key] = label
        except TypeError:
            pass
        return label

    def _expected_duration(self, task: Task,
                           q_cache: Dict[str, Optional[float]]
                           ) -> "tuple[Optional[float], str]":
        """(expected seconds, source) for the straggler threshold: the
        kernel's measured p99 once ``speculation_min_samples`` dispatches
        exist, else the static ``duration_hint`` (cold-start fallback)."""
        kernel = self._task_kernel(task)
        if kernel is not None:
            if kernel not in q_cache:
                q = tel.quantiles(kernel)
                q_cache[kernel] = (
                    q.get("p99")
                    if (q.get("count") or 0) >= self.speculation_min_samples
                    else None)
            p99 = q_cache[kernel]
            if p99 is not None:
                return p99, "p99"
        return task.duration_hint, "hint"

    def _watchdog_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.heartbeat_interval)
            if self._stop.is_set():
                return
            rts = self.rts
            if rts is None or not hasattr(rts, "running_since"):
                continue
            try:
                running = rts.running_since()
            except Exception:  # noqa: BLE001
                continue
            # one quantile lookup per kernel per sweep, not per task
            q_cache: Dict[str, Optional[float]] = {}
            with self._lock:
                candidates = []
                for uid, elapsed in running.items():
                    task = self._submitted.get(uid)
                    if task is None or uid in self._speculated:
                        continue
                    if uid in self._spec_of:   # don't speculate on clones
                        continue
                    expect, source = self._expected_duration(task, q_cache)
                    if expect is None:
                        continue
                    threshold = max(self.straggler_min_seconds,
                                    self.straggler_factor * expect)
                    if elapsed > threshold:
                        candidates.append((task, source))
                clones = []
                for task, source in candidates:
                    clone = self._clone_for_speculation(task)
                    self._spec_of[clone.uid] = task.uid
                    self._spec_for[task.uid] = clone.uid
                    self._speculated.add(task.uid)
                    self.speculations += 1
                    if source == "p99":
                        self.speculations_from_quantile += 1
                    else:
                        self.speculations_from_hint += 1
                    tel.counter("speculation_total", source=source).inc()
                    clones.append(clone)
            if clones:
                rts.submit(clones)

    @staticmethod
    def _clone_for_speculation(task: Task) -> Task:
        # drop the federation placement hint: the clone should be free to
        # land on a different (less loaded / healthier) member than the
        # straggling original; the affinity constraint itself is kept.
        # The chain/DAG tags are dropped too: a lone clone must run as an
        # ordinary (scalar/group) task against the result store — by
        # speculation time its upstream links are long routed — instead of
        # waiting in the chain assembler for siblings that never come.
        tags = {k: v for k, v in task.tags.items()
                if k not in ("_fed_member", CHAIN_TAG, DAG_TAG)}
        clone = Task(
            name=f"{task.name}#spec",
            executable=task._fn if task._fn is not None else task.executable,
            args=task.args, kwargs=task.kwargs, slots=task.slots,
            duration_hint=task.duration_hint,
            tags={**tags, "speculative_of": task.uid},
            backend=task.backend,
        )
        return clone

    # -- introspection ------------------------------------------------------#

    def n_in_custody(self) -> int:
        with self._lock:
            return len(self._submitted)
