"""Fused execution engine: N congruent tasks → one batched PyTorch dispatch.

Given a micro-batch of member tasks (same kernel, congruent kwargs — see
:mod:`repro_torch.fusion.groups`), the engine

1. resolves each member's callable and kwargs (trampoline-aware: tasks
   compiled by ``repro_torch.api`` carry ``{"__future__": ...}``
   placeholders that resolve against the result store, exactly as the
   scalar path does),
2. stacks the batch kwargs onto a leading axis on the leased device —
   padding declared variable-length arguments to the group maximum by edge
   replication, which is safe for per-row kernels because padded rows are
   trimmed from the outputs before delivery,
3. dispatches **once**: the kernel's hand-written batched implementation
   when it has one, else ``torch.func.vmap`` of the scalar kernel, cached
   on (kernel, static arguments),
4. waits on a CUDA event recorded after the dispatch (never a device-wide
   synchronize) and fans the stacked output back out as one completion per
   member — every member gets its own DONE/FAILED event, so journal
   records, retry budgets and resume semantics are per-task, exactly as if
   the members had run scalar.

This covers the scalar and per-stage fused tiers. :class:`ChainExecution`
runs one fused micro-batch asynchronously: the carrier's worker thread
resolves, stacks and enqueues the dispatch; a completion drainer waits on
the event and fans out. Composed chains, DAG carriers and sharded carriers
are not ported yet.

Failure isolation: a member whose outputs contain non-finite values FAILS
while every other member completes; an exception raised by the batched
dispatch degrades the micro-batch to per-member scalar execution so only
the actually-culpable members fail.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import telemetry as tel
from ..core.pst import Task, resolve_executable
from ..rts.base import TaskCompletion
from .groups import FusionSpec, fusion_spec
from .handles import ArrayResult, LazySlice

Deliver = Callable[[TaskCompletion], None]

# vmap-cache accounting: hit / miss (a miss builds a new vmapped callable)
# / uncached (a non-hashable statics key bypasses the cache entirely) /
# eviction (LRU pressure). Same metric names as the JAX package's jit cache.
_JIT_HITS = tel.counter("fusion_jit_cache_total", outcome="hit")
_JIT_MISSES = tel.counter("fusion_jit_cache_total", outcome="miss")
_JIT_UNCACHED = tel.counter("fusion_jit_cache_total", outcome="uncached")
_JIT_EVICTIONS = tel.counter("fusion_jit_cache_evictions_total")


def _kernel_label(fn: Any) -> str:
    """Stable per-kernel metric label (the dispatch-latency family key)."""
    return getattr(fn, "__name__", None) or str(fn)

#: chaos-plane hook: when set, every carrier consults it once at dispatch
#: time with the execution object; True ⇒ the batched dispatch raises and
#: the carrier walks the degrade ladder (fused → per-member scalar).
#: Members are never lost — the hook exercises the same path a real
#: mid-dispatch device failure takes.
CARRIER_FAULT: Optional[Callable[[Any], bool]] = None

TRAMPOLINE = "reg://_api.call"

# (kernel, static kwargs, batch kwarg names) -> vmapped callable. PyTorch
# runs eagerly, so the cache saves rebuilding the vmap wrapper, not a
# compile; it keeps the JAX package's key and LRU bound (a workflow
# sweeping a static argument must not grow it without limit).
_JIT_CACHE_MAX = 64
_jit_cache: "OrderedDict[Tuple, Callable[..., Any]]" = OrderedDict()
_jit_lock = threading.Lock()

# task uid -> (fn, args, kwargs) with ArrayResult handles unwrapped: the
# RTS's kernel-spec probe and the dispatch both resolve a member. Entries
# are dropped when the member's completion is delivered, so retries always
# re-resolve.
_CALL_CACHE_MAX = 16384
_call_cache: "OrderedDict[str, Tuple[Callable, list, dict]]" = OrderedDict()
_call_lock = threading.Lock()

# (kernel, frozenset(kwarg names)) -> (static names, shared names, batch
# names): the kwarg partition is identical for every micro-batch of a group.
_part_cache: "OrderedDict[Tuple, Tuple[tuple, tuple, tuple]]" = OrderedDict()
_PART_CACHE_MAX = 256


class Incongruent(Exception):
    """Members cannot share a dispatch; the caller runs them scalar."""


# --------------------------------------------------------------------------- #
# Member resolution
# --------------------------------------------------------------------------- #

def _unwrap(value: Any) -> Any:
    """Unwrap ArrayResult handles nested in resolved kwargs."""
    if isinstance(value, ArrayResult):
        return value.value
    if isinstance(value, (list, tuple)):
        return type(value)(_unwrap(v) for v in value)
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    return value


def _resolve_call(task: Task) -> Tuple[Callable[..., Any], list, dict]:
    if task.executable == TRAMPOLINE:
        from ..api.runtime import resolve as resolve_placeholders
        ns = task.kwargs["__ns__"]
        fn = resolve_executable(task.kwargs["__fn__"])
        args = resolve_placeholders(task.kwargs["__args__"], ns)
        kwargs = resolve_placeholders(task.kwargs["__kwargs__"], ns)
        return fn, [_unwrap(a) for a in args], \
            {k: _unwrap(v) for k, v in kwargs.items()}
    return task.resolve(), [_unwrap(a) for a in task.args], \
        {k: _unwrap(v) for k, v in task.kwargs.items()}


def member_call(task: Task) -> Tuple[Callable[..., Any], list, dict]:
    """Resolve one member task to (fn, args, kwargs), placeholders resolved
    and ArrayResult handles unwrapped.

    Tasks compiled by the declarative API run through the registered
    trampoline; fusing must look *through* it to the user kernel, resolving
    the same future placeholders the trampoline would. The resolution is
    cached per task; callers must treat the returned structures as
    read-only.
    """
    with _call_lock:
        hit = _call_cache.get(task.uid)
        if hit is not None:
            _call_cache.move_to_end(task.uid)
            return hit
    call = _resolve_call(task)
    with _call_lock:
        _call_cache[task.uid] = call
        while len(_call_cache) > _CALL_CACHE_MAX:
            _call_cache.popitem(last=False)
    return call


def drop_member_call(uid: str) -> None:
    """Invalidate a member's cached resolution (delivery/retry boundary)."""
    with _call_lock:
        _call_cache.pop(uid, None)


# --------------------------------------------------------------------------- #
# Batch preparation
# --------------------------------------------------------------------------- #

def _partition(fn: Callable, spec: FusionSpec, kwargs0: dict
               ) -> Tuple[tuple, tuple, tuple]:
    """(static names, shared names, batch names) for one group's kwargs —
    cached: the partition never changes between micro-batches of a group."""
    key = (fn, frozenset(kwargs0))
    with _jit_lock:
        part = _part_cache.get(key)
        if part is not None:
            _part_cache.move_to_end(key)
            return part
    statics = tuple(k for k in spec.static_argnames if k in kwargs0)
    shareds = tuple(k for k in spec.shared_argnames if k in kwargs0)
    batch = tuple(k for k in kwargs0
                  if k not in statics and k not in shareds)
    part = (statics, shareds, batch)
    with _jit_lock:
        _part_cache[key] = part
        while len(_part_cache) > _PART_CACHE_MAX:
            _part_cache.popitem(last=False)
    return part


def _pad_rows(leaf: Any, target: int) -> Any:
    """Edge-replicate the last row of ``leaf`` up to ``target`` rows."""
    extra = target - leaf.shape[0]
    if extra == 0:
        return leaf
    if isinstance(leaf, torch.Tensor):
        last = leaf[-1:].expand(extra, *leaf.shape[1:])
        return torch.cat([leaf, last])
    return np.concatenate([leaf, np.repeat(leaf[-1:], extra, axis=0)])


def _to_device(arr: Any, device: torch.device) -> torch.Tensor:
    """A host-stacked batch array as a tensor on ``device``. float64 becomes
    float32: member values arrive as Python floats far more often than as
    genuine float64 arrays, and a scalar kernel turning the same values
    into a tensor gets torch's float32 default."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr).to(device)


def _prepare(calls: Sequence[Tuple[Callable, list, dict]],
             device: torch.device):
    """Validate congruence and stack the batch kwargs on ``device``.

    Returns ``(fn, spec, static_kw, shared_kw, stacked, valid_lens,
    padded_b)`` where ``stacked`` maps batch kwarg → tensor with leading
    axis ``padded_b`` (the batch axis bucketed to a power of two) and
    ``valid_lens`` is the per-member unpadded length (None when no padding
    was needed).
    """
    fn0, args0, kwargs0 = calls[0]
    spec = fusion_spec(fn0)
    if spec is None:
        raise Incongruent("kernel lost its fusion marker")
    keys0 = set(kwargs0)
    for fn, args, kwargs in calls:
        if fn is not fn0 or args or set(kwargs) != keys0:
            raise Incongruent("members disagree on kernel or kwarg names")
    static_names, shared_names, batch_keys = _partition(fn0, spec, kwargs0)
    static_kw = {k: kwargs0[k] for k in static_names}
    for _, _, kwargs in calls[1:]:
        for k, v in static_kw.items():
            if kwargs[k] != v:
                raise Incongruent(f"static argument {k!r} differs "
                                  f"within the group")
    shared_kw = {k: kwargs0[k] for k in shared_names}
    for _, _, kwargs in calls[1:]:
        for k, v0 in shared_kw.items():
            v = kwargs[k]
            if v is v0:
                continue  # the common case: one object shared by reference
            if isinstance(v0, torch.Tensor) or isinstance(v, torch.Tensor):
                same = (isinstance(v0, torch.Tensor)
                        and isinstance(v, torch.Tensor)
                        and v0.shape == v.shape and v0.dtype == v.dtype
                        and v0.device == v.device and torch.equal(v0, v))
            else:
                a0, a1 = np.asarray(v0), np.asarray(v)
                same = (a0.shape == a1.shape and a0.dtype == a1.dtype
                        and np.array_equal(a0, a1))
            if not same:
                # the group key cannot see shared VALUES, so two
                # congruent-looking ensembles with different shared arrays
                # must be caught here — a silent first-member pick would
                # compute every other member against the wrong array
                raise Incongruent(
                    f"shared argument {k!r} differs within the group")

    stacked: Dict[str, Any] = {}
    valid_lens: Optional[List[int]] = None
    for k in batch_keys:
        raw = [kwargs[k] for _, _, kwargs in calls]
        # stack host-side with numpy unless a leaf is already a device
        # tensor (an upstream fused stage's output): one host stack and
        # one upload beat a device op per member
        if any(isinstance(v, torch.Tensor) for v in raw):
            dev = next(v.device for v in raw if isinstance(v, torch.Tensor))
            leaves = [torch.as_tensor(v, device=dev) for v in raw]
        else:
            leaves = [np.asarray(v) for v in raw]
        shapes = {tuple(leaf.shape) for leaf in leaves}
        if len(shapes) > 1:
            if k not in spec.pad_argnames:
                raise Incongruent(
                    f"argument {k!r} varies in shape but is not declared "
                    f"in pad_argnames")
            if any(leaf.ndim == 0 or leaf.shape[1:] != leaves[0].shape[1:]
                   for leaf in leaves):
                raise Incongruent(
                    f"pad argument {k!r} members differ beyond axis 0")
            lens = [int(leaf.shape[0]) for leaf in leaves]
            if any(n == 0 for n in lens):
                raise Incongruent(f"pad argument {k!r} has an empty member")
            target = max(lens)
            leaves = [_pad_rows(leaf, target) for leaf in leaves]
            if valid_lens is None:
                valid_lens = lens
            elif valid_lens != lens:
                raise Incongruent("pad arguments disagree on member lengths")
        stacked[k] = (torch.stack(leaves)
                      if isinstance(leaves[0], torch.Tensor)
                      else np.stack(leaves))
    # Bucket the batch axis to the next power of two by duplicating the
    # last member, as the JAX package does (there it bounds recompiles;
    # here it keeps batch shapes, and so kernel launch shapes, few). The
    # duplicate rows compute and are discarded at fan-out.
    b = len(calls)
    target_b = 1 << max(0, b - 1).bit_length()
    for k, arr in stacked.items():
        stacked[k] = _to_device(_pad_rows(arr, target_b), device)
    return fn0, spec, static_kw, shared_kw, stacked, valid_lens, target_b


# --------------------------------------------------------------------------- #
# Dispatch
# --------------------------------------------------------------------------- #

def _statics_key(static_kw: dict) -> Optional[Tuple]:
    try:
        key = tuple(sorted(static_kw.items()))
        hash(key)
        return key
    except TypeError:
        return None


def _jit_cached(cache_key: Optional[Tuple], build: Callable[[], Callable]
                ) -> Callable:
    if cache_key is None:
        _JIT_UNCACHED.inc()
        return build()
    with _jit_lock:
        fn = _jit_cache.get(cache_key)
        if fn is not None:
            _jit_cache.move_to_end(cache_key)
            _JIT_HITS.inc()
            return fn
    _JIT_MISSES.inc()
    fn = build()
    with _jit_lock:
        _jit_cache[cache_key] = fn
        while len(_jit_cache) > _JIT_CACHE_MAX:
            _jit_cache.popitem(last=False)
            _JIT_EVICTIONS.inc()
    return fn


def _dispatch(fn, spec: FusionSpec, static_kw: dict, shared_kw: dict,
              stacked: dict):
    """One batched device dispatch over the stacked kwargs."""
    if spec.batched is not None:
        return spec.batched(**stacked, **static_kw, **shared_kw)
    skey = _statics_key(static_kw)
    cache_key = None if skey is None else (fn, skey, tuple(sorted(stacked)))

    def build():
        def call(batched: dict, shared: dict):
            return fn(**batched, **shared, **static_kw)
        return torch.func.vmap(call, in_dims=(0, None))

    return _jit_cached(cache_key, build)(stacked, shared_kw)


def _lease_device(devices: Sequence[Any]) -> torch.device:
    """The device a carrier's batch is stacked on: its first leased one."""
    if not devices:
        raise Incongruent("carrier holds no device lease")
    return torch.device(devices[0])


def _completion_event(out: Any) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded on the current stream right after the
    dispatch that produced ``out`` (None for CPU outputs, which are ready
    when the call returns). Waiting on it waits for this dispatch only."""
    for leaf in pytree.tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(leaf.device))
            return event
    return None


def _wait(event: Optional["torch.cuda.Event"]) -> None:
    if event is not None:
        event.synchronize()


# --------------------------------------------------------------------------- #
# Fan-out
# --------------------------------------------------------------------------- #

class _FanOut:
    """Turns one stacked output pytree into per-member results.

    Built once per dispatch: per-member-scalar leaves (ndim == 1) transfer
    to the host in ONE copy and fan out as Python scalars; higher-rank
    leaves stay on the device and members receive LAZY slices
    (:class:`~repro_torch.fusion.handles.LazySlice`). The finite mask is
    likewise one reduction per leaf, a single device→host copy for the
    whole batch instead of one per member.
    """

    def __init__(self, out: Any, n_live: int, check_finite: bool,
                 valid_lens: Optional[List[int]]) -> None:
        self.leaves, self.treedef = pytree.tree_flatten(out)
        self.valid_lens = valid_lens
        self.padded_len = max(valid_lens) if valid_lens else None
        self.ok = np.ones(n_live, bool)
        self.host: Dict[int, np.ndarray] = {}
        for idx, leaf in enumerate(self.leaves):
            arr = (leaf if isinstance(leaf, torch.Tensor)
                   else torch.as_tensor(np.asarray(leaf)))
            self.leaves[idx] = arr
            if arr.ndim == 1:
                self.host[idx] = arr.detach().cpu().numpy()
            if check_finite and arr.is_floating_point():
                fin = torch.isfinite(arr.reshape(arr.shape[0], -1)).all(dim=1)
                self.ok &= fin.cpu().numpy()[:n_live]

    def member(self, i: int) -> Any:
        def pick(idx: int) -> Any:
            if idx in self.host:
                return self.host[idx][i].item()
            leaf = self.leaves[idx]
            trim = None
            if (self.valid_lens is not None and leaf.ndim >= 2
                    and leaf.shape[1] == self.padded_len
                    and self.valid_lens[i] < self.padded_len):
                trim = self.valid_lens[i]
            return LazySlice(leaf, i, trim=trim)

        return pytree.tree_unflatten(
            [pick(idx) for idx in range(len(self.leaves))], self.treedef)


# --------------------------------------------------------------------------- #
# Single-link entry point (also the carrier's degrade unit)
# --------------------------------------------------------------------------- #

def execute_fused(
    members: Sequence[Task],
    devices: Sequence[Any],
    cancel_event: threading.Event,
    deliver: Deliver,
    *,
    canceled: Optional[set] = None,
    fault_injector: Optional[Callable[[Task], bool]] = None,
) -> Dict[str, int]:
    """Run ``members`` as one fused dispatch; deliver one completion each.

    Returns execution statistics (``fused`` / ``scalar_fallback`` /
    ``failed`` member counts). ``canceled`` uids are skipped without a
    completion (the same semantics as dropping a queued task on cancel);
    ``fault_injector`` is honoured per member so the failure experiments
    behave identically on the fused path.
    """
    canceled = canceled or set()
    # "dispatches" counts BATCHED dispatches only: a micro-batch that
    # degraded to per-member scalar execution contributes zero, so the
    # dispatch counts cannot mask a silently-degraded run
    stats = {"fused": 0, "scalar_fallback": 0, "failed": 0, "dispatches": 0}
    started = time.time()

    def finish(task: Task, exit_code: int, result: Any = None,
               exception: Optional[str] = None, n_live: int = 1) -> None:
        # invalidate BEFORE the cancel skip: a canceled member delivers no
        # completion, but leaving its resolved arrays pinned in the call
        # cache until LRU eviction would retain them long past the run
        drop_member_call(task.uid)
        if task.uid in canceled:
            return
        now = time.time()
        if exit_code == 1:
            stats["failed"] += 1
        deliver(TaskCompletion(
            uid=task.uid, exit_code=exit_code, result=result,
            exception=exception, started_at=started, completed_at=now,
            execution_seconds=(now - started) / max(1, n_live)))

    live: List[Task] = []
    for task in members:
        if task.uid in canceled:
            continue
        if cancel_event.is_set():
            finish(task, -2)
            continue
        if fault_injector is not None and fault_injector(task):
            finish(task, 1, exception="injected fault")
            continue
        live.append(task)
    if not live:
        return stats

    try:
        calls = [member_call(t) for t in live]
        fn, spec, static_kw, shared_kw, stacked, valid_lens, _ = \
            _prepare(calls, _lease_device(devices))
        t0 = time.perf_counter()
        out = _dispatch(fn, spec, static_kw, shared_kw, stacked)
        _wait(_completion_event(out))
        tel.observe_dispatch(_kernel_label(fn), "fused",
                             time.perf_counter() - t0)
        fan = _FanOut(out, len(live), spec.check_finite,
                      valid_lens if spec.trim_outputs else None)
        stats["dispatches"] = 1
    except Exception:  # noqa: BLE001 - degrade to per-member execution
        return _scalar_fallback(live, cancel_event, finish, stats)

    for i, task in enumerate(live):
        if cancel_event.is_set():
            finish(task, -2)
            continue
        if not fan.ok[i]:
            finish(task, 1, exception=(
                "non-finite values in fused dispatch output "
                f"(member {task.name})"), n_live=len(live))
            continue
        finish(task, 0, result=fan.member(i), n_live=len(live))
        stats["fused"] += 1
    return stats


def _non_finite(result: Any) -> bool:
    """True when a floating-point array result holds a NaN or an inf."""
    if isinstance(result, torch.Tensor):
        return result.is_floating_point() and \
            not bool(torch.isfinite(result).all())
    if hasattr(result, "dtype"):
        arr = np.asarray(result)
        return np.issubdtype(arr.dtype, np.floating) and \
            not np.isfinite(arr).all()
    return False


def _scalar_fallback(live: Sequence[Task], cancel_event: threading.Event,
                     finish, stats: Dict[str, int]) -> Dict[str, int]:
    """The batched dispatch raised (or could not be built): run each member
    on its own so only the actually-failing members fail."""
    for task in live:
        if cancel_event.is_set():
            finish(task, -2)
            continue
        try:
            fn, args, kwargs = member_call(task)
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            tel.observe_dispatch(_kernel_label(fn), "scalar",
                                 time.perf_counter() - t0)
            spec = fusion_spec(fn)
            if spec is not None and spec.check_finite and _non_finite(result):
                finish(task, 1, exception=(
                    f"non-finite values in scalar fallback output "
                    f"(member {task.name})"))
                continue
            finish(task, 0, result=result)
            stats["scalar_fallback"] += 1
        except Exception:  # noqa: BLE001 - per-member isolation
            finish(task, 1, exception=traceback.format_exc(limit=10))
    return stats


# --------------------------------------------------------------------------- #
# Carrier execution (async: dispatch on the carrier worker, drain elsewhere)
# --------------------------------------------------------------------------- #

class ChainExecution:
    """One fused micro-batch through one carrier, asynchronously.

    The carrier worker calls :meth:`dispatch` — resolve, stack, enqueue the
    batched dispatch, record a CUDA event after it — and returns. The RTS's
    completion drainer calls :meth:`drain`, which waits on that event and
    fans out the per-member completions. Only one-link carriers exist in
    this package: composed multi-link chains are not ported, so ``links``
    must hold exactly one member list.

    Degrade ladder: a dispatch that raises (or whose failure surfaces at the
    wait) re-runs the members through :func:`execute_fused`, which falls
    back to per-member scalar execution if the fused dispatch fails again.
    """

    def __init__(self, links: Sequence[Sequence[Task]],
                 devices: Sequence[Any],
                 cancel_event: threading.Event,
                 deliver: Deliver,
                 *,
                 canceled: Optional[set] = None,
                 fault_injector: Optional[Callable[[Task], bool]] = None
                 ) -> None:
        if len(links) != 1:
            raise ValueError(f"ChainExecution takes one link, got "
                             f"{len(links)}: the chain tier is not ported")
        self.tasks: List[Task] = list(links[0])
        self.devices = devices
        self.cancel_event = cancel_event
        self.deliver = deliver
        self.canceled = canceled if canceled is not None else set()
        self.fault_injector = fault_injector
        self.started = time.time()
        self.tier = "fused"
        self.stats = {"fused": 0, "scalar_fallback": 0, "failed": 0,
                      "dispatches": 0, "chain_links": 0,
                      "sharded_dispatches": 0, "degraded": 0}
        self._injected: set = set()      # member index -> injected fault
        self._plan: Optional[Tuple[Callable, FusionSpec, Any]] = None
        self._records: deque = deque()
        self._cv = threading.Condition()
        self._delivered: set = set()

    # -- record stream ---------------------------------------------------- #

    def _push(self, record: Tuple) -> None:
        with self._cv:
            self._records.append(record)
            self._cv.notify_all()

    def _pop(self, stop_event: Optional[threading.Event]) -> Optional[Tuple]:
        with self._cv:
            while not self._records:
                if stop_event is not None and stop_event.is_set():
                    return None
                self._cv.wait(timeout=0.5)
            return self._records.popleft()

    # -- delivery --------------------------------------------------------- #

    def _finish(self, task: Task, exit_code: int, result: Any = None,
                exception: Optional[str] = None, n_live: int = 1) -> None:
        drop_member_call(task.uid)   # before the cancel skip: see finish()
        if task.uid in self.canceled or task.uid in self._delivered:
            return
        self._delivered.add(task.uid)
        now = time.time()
        if exit_code == 1:
            self.stats["failed"] += 1
        self.deliver(TaskCompletion(
            uid=task.uid, exit_code=exit_code, result=result,
            exception=exception, started_at=self.started, completed_at=now,
            execution_seconds=(now - self.started) / max(1, n_live)))

    # -- worker side ------------------------------------------------------ #

    def dispatch(self) -> None:
        """Resolve inputs, stack, and enqueue the batched dispatch.

        Never raises: a preparation/dispatch failure streams a ``degrade``
        record and the drainer runs the fallback.
        """
        try:
            if CARRIER_FAULT is not None and CARRIER_FAULT(self):
                raise RuntimeError("injected carrier fault (chaos plane)")
            self._dispatch_link()
        except Exception:  # noqa: BLE001 - drainer owns the fallback
            self._push(("degrade", traceback.format_exc(limit=10)))
        self._push(("end",))

    def _dispatch_link(self) -> None:
        if not self.tasks:
            return
        if self.cancel_event.is_set():
            self._push(("canceled",))
            return
        if self.fault_injector is not None:
            self._injected = {i for i, t in enumerate(self.tasks)
                              if self.fault_injector(t)}
        calls = [member_call(t) for t in self.tasks]
        fn, spec, static_kw, shared_kw, stacked, valid_lens, _ = \
            _prepare(calls, _lease_device(self.devices))
        self._plan = (fn, spec, valid_lens)
        out = _dispatch(fn, spec, static_kw, shared_kw, stacked)
        event = _completion_event(out)
        self.stats["dispatches"] += 1
        self._push(("link", out, event, time.perf_counter()))

    # -- drainer side ----------------------------------------------------- #

    def drain(self, stop_event: Optional[threading.Event] = None
              ) -> Dict[str, int]:
        """Wait for the dispatch and fan out per-member completions;
        returns the accumulated statistics."""
        while True:
            rec = self._pop(stop_event)
            if rec is None:        # RTS stopping: abandon without fabricating
                return self.stats
            kind = rec[0]
            if kind == "link":
                self._fan_link(*rec[1:])
            elif kind == "degrade":
                self.stats["degraded"] += 1
                self._degrade()
            elif kind == "canceled":
                for t in self.tasks:
                    self._finish(t, -2)
            elif kind == "end":
                return self.stats

    def _fan_link(self, out: Any, event: Optional["torch.cuda.Event"],
                  t_dispatch: float) -> None:
        fn, spec, valid_lens = self._plan
        n = len(self.tasks)
        try:
            _wait(event)
            tel.observe_dispatch(_kernel_label(fn), self.tier,
                                 time.perf_counter() - t_dispatch)
            fan = _FanOut(out, n, spec.check_finite,
                          valid_lens if spec.trim_outputs else None)
        except Exception:  # noqa: BLE001 - an async device error surfaced
            self.stats["degraded"] += 1
            self._degrade()
            return
        for i, task in enumerate(self.tasks):
            if self.cancel_event.is_set():
                self._finish(task, -2)
            elif i in self._injected:
                self._finish(task, 1, exception="injected fault", n_live=n)
            elif not fan.ok[i]:
                self._finish(task, 1, exception=(
                    "non-finite values in fused dispatch output "
                    f"(member {task.name})"), n_live=n)
            else:
                self._finish(task, 0, result=fan.member(i), n_live=n)
                self.stats["fused"] += 1

    def _degrade(self) -> None:
        """Fallback: the members (less injected faults) through
        :func:`execute_fused`, i.e. a fresh fused dispatch and, if that
        fails too, per-member scalar execution."""
        todo: List[Task] = []
        for i, task in enumerate(self.tasks):
            if self.cancel_event.is_set():
                self._finish(task, -2)
            elif i in self._injected:
                self._finish(task, 1, exception="injected fault",
                             n_live=len(self.tasks))
            else:
                todo.append(task)
        if not todo:
            return

        def dl(c: TaskCompletion) -> None:
            if c.uid in self.canceled or c.uid in self._delivered:
                return
            self._delivered.add(c.uid)
            self.deliver(c)

        sub = execute_fused(todo, self.devices, self.cancel_event, dl,
                            canceled=self.canceled)
        for key in ("fused", "scalar_fallback", "failed", "dispatches"):
            self.stats[key] += sub.get(key, 0)
