"""Fused execution engine: N congruent tasks → batched PyTorch dispatches.

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
3. dispatches **once per link**: the kernel's hand-written batched
   implementation when it has one, else ``torch.func.vmap`` of the scalar
   kernel,
4. waits on a CUDA event recorded after the dispatch (never a device-wide
   synchronize) and fans the stacked output back out as one completion per
   member — every member gets its own DONE/FAILED event, so journal
   records, retry budgets and resume semantics are per-task, exactly as if
   the members had run scalar.

Chain tier: :class:`ChainExecution` takes a *list* of links (one
micro-batch of members through L elementwise stages) and composes
consecutive vmap-able links into one segment — ``vmap`` of each link in
turn with the stacked intermediate carried on the device, never re-stacked
on the host. A hand-batched link runs eagerly between segments, and its
output stays on the device too. Execution is asynchronous: the carrier's
worker thread resolves, stacks and enqueues the dispatches, recording one
CUDA event after each dispatch (a composed segment is one dispatch), and a
completion drainer waits on each event in link order and fans out the
per-stage, per-member completions.

DAG tier: :class:`DagExecution` runs a whole fan-in/fan-out round —
``ensemble → then → gather → broadcast → ensemble`` — through one carrier:
reductions run masked on the device (:func:`_apply_reduction`) inside the
composed segment, and their value is broadcast into the next ensemble node
as a device tensor.

Sharded tier: a carrier leased a mesh of places (:func:`build_mesh` —
distinct CUDA devices, or lanes of one device,
:class:`~repro_torch.device.VirtualDevice`) splits its member axis into
one equal shard per place and runs every dispatch on each place's shard,
inside that place's device and stream context, so the places' launches
overlap. Intermediates stay on their place between links
(:class:`~repro_torch.fusion.handles.ShardedValue`); each place records
its own completion event, and a member's fan-out waits only on the place
that owns its row. A DAG reduction combines the places' partials on the
leader, in place order, and copies the result back to every place.

Failure isolation: a member whose outputs contain non-finite values at
link *k* FAILS at *k* and its downstream links fail with an upstream
marker, while every other member completes; an exception raised by a
composed or batched dispatch degrades the remaining links to per-stage
fused execution (consuming the carrier's own upstream values), and a
failing per-stage dispatch degrades further to per-member scalar execution
so only the actually-culpable members fail. Resume of a partially-failed
batch therefore re-runs exactly the failed members, re-entering mid-chain
from the last journaled link.
"""

from __future__ import annotations

import contextlib
import logging
import math
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
from ..device import VirtualDevice, place_device
from ..rts.base import TaskCompletion
from .groups import FusionSpec, fusion_spec, parse_dag_tag, reduction_spec
from .handles import ArrayResult, LazySlice, ShardedValue, to_host

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


def _resolve_call(task: Task, overrides: Optional[Dict[str, Any]]
                  ) -> Tuple[Callable[..., Any], list, dict]:
    if task.executable == TRAMPOLINE:
        from ..api.runtime import resolve as resolve_placeholders
        ns = task.kwargs["__ns__"]
        fn = resolve_executable(task.kwargs["__fn__"])
        if overrides:
            args = _resolve_over(task.kwargs["__args__"], ns, overrides)
            kwargs = _resolve_over(task.kwargs["__kwargs__"], ns, overrides)
        else:
            args = resolve_placeholders(task.kwargs["__args__"], ns)
            kwargs = resolve_placeholders(task.kwargs["__kwargs__"], ns)
        return fn, [_unwrap(a) for a in args], \
            {k: _unwrap(v) for k, v in kwargs.items()}
    return task.resolve(), [_unwrap(a) for a in task.args], \
        {k: _unwrap(v) for k, v in task.kwargs.items()}


def _resolve_over(value: Any, ns: str, overrides: Dict[str, Any]) -> Any:
    """Placeholder resolution that prefers chain-carried values over the
    store (mid-chain degrades must never race the Dequeue's store routing;
    the carrier already holds the upstream member values)."""
    from ..api.runtime import FUTURE_KEY
    from ..core.results import STORE

    if isinstance(value, dict):
        if set(value) == {FUTURE_KEY}:
            name = value[FUTURE_KEY]
            if name in overrides:
                return overrides[name]
            return STORE.get(ns, name)
        return {k: _resolve_over(v, ns, overrides) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_over(v, ns, overrides) for v in value]
    return value


def member_call(task: Task, overrides: Optional[Dict[str, Any]] = None
                ) -> Tuple[Callable[..., Any], list, dict]:
    """Resolve one member task to (fn, args, kwargs), placeholders resolved
    and ArrayResult handles unwrapped.

    Tasks compiled by the declarative API run through the registered
    trampoline; fusing must look *through* it to the user kernel, resolving
    the same future placeholders the trampoline would. The resolution is
    cached per task; callers must treat the returned structures as
    read-only. ``overrides`` (chain degrade) resolves future placeholders
    from the carrier's already-computed upstream values first, uncached.
    """
    if overrides:
        return _resolve_call(task, overrides)
    with _call_lock:
        hit = _call_cache.get(task.uid)
        if hit is not None:
            _call_cache.move_to_end(task.uid)
            return hit
    call = _resolve_call(task, None)
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
             device: torch.device, pad_to: Optional[int] = None):
    """Validate congruence and stack the batch kwargs on ``device``.

    Returns ``(fn, spec, static_kw, shared_kw, stacked, valid_lens,
    padded_b)`` where ``stacked`` maps batch kwarg → tensor with leading
    axis ``padded_b`` (the batch axis bucketed to a power of two, or to
    ``pad_to`` when a chain entry already fixed the bucket) and
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
    # duplicate rows compute and are discarded at fan-out. A chain entry
    # fixes the bucket for every downstream link (``pad_to``): the carried
    # axis must stay congruent through the whole composed segment.
    b = len(calls)
    target_b = pad_to if pad_to is not None \
        else 1 << max(0, b - 1).bit_length()
    if target_b < b:
        raise Incongruent("chain links disagree on member count")
    for k, arr in stacked.items():
        stacked[k] = _to_device(_pad_rows(arr, target_b), device)
    return fn0, spec, static_kw, shared_kw, stacked, valid_lens, target_b


def _continuation_calls(tasks: Sequence[Task], prev_tasks: Sequence[Task]
                        ) -> Tuple[List[Tuple[Callable, list, dict]], str]:
    """Resolve a continuation link's members WITHOUT touching their carried
    input: the carry arrives device-resident from the previous link, so its
    placeholder must not hit the result store (mid-chain it has no value
    there yet). Returns the carry kwarg name."""
    from ..api.runtime import FUTURE_KEY
    from ..api.runtime import resolve as resolve_placeholders

    calls: List[Tuple[Callable, list, dict]] = []
    names: set = set()
    for t, prev in zip(tasks, prev_tasks):
        if t.executable != TRAMPOLINE:
            raise Incongruent("chain link is not a data-flow task")
        if t.kwargs.get("__args__"):
            raise Incongruent("chain link has positional args")
        ns = t.kwargs["__ns__"]
        fn = resolve_executable(t.kwargs["__fn__"])
        carry_k = None
        other: Dict[str, Any] = {}
        for k, v in (t.kwargs.get("__kwargs__") or {}).items():
            if isinstance(v, dict) and set(v) == {FUTURE_KEY}:
                if v[FUTURE_KEY] == prev.name and carry_k is None:
                    carry_k = k
                    continue
                raise Incongruent("chain link consumes a non-chain future")
            other[k] = _unwrap(resolve_placeholders(v, ns))
        if carry_k is None:
            raise Incongruent("chain link does not consume its predecessor")
        calls.append((fn, [], other))
        names.add(carry_k)
    if len(names) != 1:
        raise Incongruent("chain links disagree on the carry kwarg")
    return calls, names.pop()


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


class _LinkPlan:
    """One prepared chain link: resolved kernel + stacked batch kwargs."""

    __slots__ = ("tasks", "fn", "spec", "static_kw", "shared_kw", "stacked",
                 "valid_lens", "carry_name", "t_dispatch", "padded_b",
                 "placed")

    def __init__(self, tasks, fn, spec, static_kw, shared_kw, stacked,
                 valid_lens, carry_name, padded_b: int = 0) -> None:
        self.tasks = tasks
        self.fn = fn
        self.spec = spec
        self.static_kw = static_kw
        self.shared_kw = shared_kw
        self.stacked = stacked
        self.valid_lens = valid_lens
        self.carry_name = carry_name
        self.t_dispatch: Optional[float] = None
        self.padded_b = padded_b
        # under a mesh: one (stacked, shared) pair per place, the stacked
        # kwargs split on the member axis and the shared ones replicated
        self.placed: Optional[List[Tuple[dict, dict]]] = None


def _vmap_link(fn: Callable, static_kw: dict, kw: dict, shared: dict) -> Any:
    """``vmap`` of one link over its stacked kwargs (the carry included);
    shared kwargs (and a DAG broadcast) ride unbatched."""
    def call(kw_: dict, sh_: dict):
        return fn(**kw_, **sh_, **static_kw)
    return torch.func.vmap(call, in_dims=(0, None))(kw, shared)


def _composed_segment(plans: Sequence[_LinkPlan], carry: Any) -> List[Any]:
    """Consecutive vmap-able links back to back, ``vmap(g)∘vmap(f)``: the
    carried intermediate is a device tensor between the links, never
    re-stacked or copied to the host. Every link's output is returned (the
    fan-out owes each stage its per-member completions)."""
    outs = []
    for p in plans:
        kw = dict(p.stacked)
        if p.carry_name is not None:
            kw[p.carry_name] = carry
        carry = _vmap_link(p.fn, p.static_kw, kw, p.shared_kw)
        outs.append(carry)
    return outs


def _lease_device(devices: Sequence[Any]) -> torch.device:
    """The device a carrier's batch is stacked on: its first leased one
    (a lane's physical device)."""
    if not devices:
        raise Incongruent("carrier holds no device lease")
    return place_device(devices[0])


# --------------------------------------------------------------------------- #
# The member-axis mesh (sharded tier)
# --------------------------------------------------------------------------- #

#: the sharded tier's link-graph counters (``fusion_stats`` keys)
GRAPH_STATS = ("graph_captures", "graph_replays", "graph_refusals")


class Mesh:
    """A 1-D member-axis mesh over distinct places: CUDA devices, or lanes
    (:class:`~repro_torch.device.VirtualDevice`) of one physical device.
    The first place is the leader: a sharded reduction combines its
    partials there. Work for place ``i`` runs inside :meth:`on`, under the
    place's device and its stream (a lane's own stream, a card's current
    one), so the places' launches overlap on the card."""

    __slots__ = ("places", "devices", "graph_stats")

    def __init__(self, places: Sequence[Any]) -> None:
        self.places = list(places)
        self.devices = [place_device(p) for p in self.places]
        # the link graphs' captures, replays and refusals on this mesh
        self.graph_stats = dict.fromkeys(GRAPH_STATS, 0)

    @property
    def size(self) -> int:
        return len(self.places)

    def stream(self, i: int):
        dev = self.devices[i]
        if dev.type != "cuda":
            return None
        place = self.places[i]
        if isinstance(place, VirtualDevice):
            return place.stream
        return torch.cuda.current_stream(dev)

    @contextlib.contextmanager
    def on(self, i: int):
        """Device and stream context of place ``i`` (nothing on the CPU)."""
        stream = self.stream(i)
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[i]), torch.cuda.stream(stream):
            yield

    def follow_leader(self) -> None:
        """Order every place's stream after the work already enqueued on
        its device's current stream (the stacking and uploads of
        :meth:`ChainExecution._place_plans`)."""
        for i in range(self.size):
            stream = self.stream(i)
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(self.devices[i]))

    def events(self) -> Optional[List[Optional["torch.cuda.Event"]]]:
        """One completion event per place, recorded on its stream now; the
        carrier's completion is the join of them. None on the CPU."""
        if self.devices[0].type != "cuda":
            return None
        out = []
        for i in range(self.size):
            event = torch.cuda.Event()
            event.record(self.stream(i))
            out.append(event)
        return out

    def put(self, value: Any, i: int) -> Any:
        """``value`` (a tensor on another stream or device) made usable on
        place ``i``: copied to its device when that differs, and marked in
        use by its stream so the caching allocator cannot hand the block
        to another stream while the place still reads it."""
        if not isinstance(value, torch.Tensor):
            return value
        dev = self.devices[i]
        if value.device != dev:
            value = value.to(dev)
        stream = self.stream(i)
        if stream is not None:
            value.record_stream(stream)
        return value

    def merge(self, outs: Sequence[Any]) -> Any:
        """Per-place outputs (one pytree each, in place order) as one
        pytree of :class:`~repro_torch.fusion.handles.ShardedValue` leaves.
        Each tensor is marked in use by its device's current stream too:
        the fan-out and the members' consumers read it there."""
        flat = [pytree.tree_flatten(o) for o in outs]
        treedef = flat[0][1]
        leaves = []
        for idx in range(len(flat[0][0])):
            shards, start = [], 0
            for i, (ls, _) in enumerate(flat):
                t = ls[idx]
                if not isinstance(t, torch.Tensor):
                    t = torch.as_tensor(t, device=self.devices[i])
                if t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
                shards.append((start, t))
                start += int(t.shape[0])
            leaves.append(ShardedValue(shards))
        return pytree.tree_unflatten(leaves, treedef)


def build_mesh(devices: Optional[Sequence[Any]]) -> Optional[Mesh]:
    """A 1-D member-axis :class:`Mesh` over ``devices``, or None when the
    lease is not meshable: empty, placeholder device names, duplicate
    entries (logical-slot oversubscription), fewer than two places, or a
    mix of lanes and cards. Two or more distinct CUDA devices mesh, and so
    do two or more lanes of one physical device."""
    if not devices:
        return None
    uniq = list(dict.fromkeys(devices))
    if len(uniq) != len(devices) or len(uniq) < 2:
        return None
    if all(isinstance(d, VirtualDevice) for d in uniq):
        if len({d.device for d in uniq}) != 1:
            return None
        return Mesh(uniq)
    if all(isinstance(d, torch.device) and d.type == "cuda"
           and d.index is not None for d in uniq):
        return Mesh(uniq)
    return None


def shard_pad(n_members: int, n_shards: int) -> int:
    """Padded batch axis for a sharded dispatch: ``n_shards`` equal shards,
    each bucketed to a power of two — the compile-shape bucketing rule of
    the micro-batch path, applied per shard. Past 512 members per shard
    the bucket quantum flattens to 256: pow2 bucketing there would pad a
    wide dispatch by up to ~2x in dead compute to save at most a handful
    of cached compiles."""
    per = max(1, math.ceil(n_members / max(1, n_shards)))
    if per > 512:
        return n_shards * (256 * math.ceil(per / 256))
    return n_shards * (1 << max(0, per - 1).bit_length())


def _local(tree: Any, i: int) -> Any:
    """Place ``i``'s part of a sharded pytree (other leaves as they are)."""
    return pytree.tree_map(
        lambda x: x.local(i) if isinstance(x, ShardedValue) else x, tree)


def _place_statics(static_kw: dict, device: torch.device) -> dict:
    """A link's static kwargs for one place: a ``device`` static (the port's
    kernels name where their data lives by it) becomes the place's device,
    so on two cards each shard computes on its own card."""
    if "device" not in static_kw:
        return static_kw
    out = dict(static_kw)
    out["device"] = str(device)
    return out


# --------------------------------------------------------------------------- #
# CUDA graphs of the sharded tier's links
# --------------------------------------------------------------------------- #

_log = logging.getLogger(__name__)

#: graphs a place keeps (an LRU); ``shard_pad`` already buckets the shapes
GRAPHS_PER_PLACE = 8


class _LinkGraph:
    """One captured link call: the graph, the static input buffers it reads
    (the tensor leaves of its kwargs, in flattening order) and the static
    outputs it writes, all on its place's graph stream."""

    __slots__ = ("graph", "static_in", "static_out")

    def __init__(self, graph, static_in: List[torch.Tensor],
                 static_out: Any) -> None:
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out

    def replay(self, leaves: Sequence[torch.Tensor], ps, cs) -> Any:
        """Copy ``leaves`` into the static inputs on the graph stream
        ``cs``, replay, and return clones of the static outputs made on the
        place's stream ``ps``: the next replay overwrites the static
        outputs while the fan-out may still read this call's."""
        if cs != ps:
            cs.wait_stream(ps)
        with torch.cuda.stream(cs):
            for dst, src in zip(self.static_in, leaves):
                dst.copy_(src)
                if cs != ps:
                    src.record_stream(cs)
            self.graph.replay()
        if cs != ps:
            ps.wait_stream(cs)
        return pytree.tree_map(torch.clone, self.static_out)


class _PlaceGraphs:
    """One place's link graphs: an LRU of at most :data:`GRAPHS_PER_PLACE`
    keys, each a :class:`_LinkGraph` or the reason its capture was refused
    (so a refused link is not captured again). The graphs share a private
    memory pool and run on one stream: a lane's own, or for a card a side
    stream ordered both ways with its current stream (the legacy default
    stream, which cannot capture)."""

    def __init__(self, device: torch.device, stream) -> None:
        self.device = device
        self.lock = threading.Lock()
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = (torch.cuda.Stream(device=device)
                       if stream == torch.cuda.default_stream(device)
                       else stream)
        self.entries: "OrderedDict[Tuple, Any]" = OrderedDict()

    def get(self, key: Tuple) -> Any:
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key: Tuple, entry: Any) -> None:
        self.entries[key] = entry
        while len(self.entries) > GRAPHS_PER_PLACE:
            self.entries.popitem(last=False)


_graph_stores: Dict[Any, _PlaceGraphs] = {}
_graph_stores_lock = threading.Lock()
_unkeyed_logged: set = set()


def release_graphs() -> None:
    """Drop every place's captured link graphs and their memory pools."""
    with _graph_stores_lock:
        _graph_stores.clear()


def _place_graphs(mesh: Mesh, i: int) -> _PlaceGraphs:
    place = mesh.places[i]
    with _graph_stores_lock:
        store = _graph_stores.get(place)
        if store is None:
            store = _graph_stores[place] = _PlaceGraphs(mesh.devices[i],
                                                        mesh.stream(i))
        return store


def _graph_key(fn: Callable, static_kw: dict, kw: dict, shared: dict
               ) -> Optional[Tuple]:
    """A link call's graph key: the kernel, its statics, and the structure,
    shapes, dtypes and devices of its kwargs (a non-tensor leaf by value,
    since the graph bakes it in); None when a part is unhashable."""
    skey = _statics_key(static_kw)
    if skey is None:
        return None
    leaves, spec = pytree.tree_flatten((kw, shared))
    sig = tuple((tuple(x.shape), x.dtype, x.device)
                if isinstance(x, torch.Tensor) else ("value", x)
                for x in leaves)
    key = (fn, skey, str(spec), sig)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _capture_link(store: _PlaceGraphs, ps, fn: Callable, static_kw: dict,
                  kw: dict, shared: dict) -> _LinkGraph:
    """Capture ``_vmap_link`` on static copies of the kwargs, on the
    place's graph stream, into its pool. Raises when the capture fails (a
    host sync, a pageable copy, a non-tensor output)."""
    cs = store.stream
    if cs != ps:
        cs.wait_stream(ps)
    with torch.cuda.stream(cs):
        s_kw, s_shared = pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            (kw, shared))
        graph = torch.cuda.CUDAGraph()
        # thread_local: the drainers and other carriers keep syncing
        graph.capture_begin(pool=store.pool,
                            capture_error_mode="thread_local")
        try:
            out = _vmap_link(fn, static_kw, s_kw, s_shared)
        finally:
            try:
                graph.capture_end()
            except Exception:
                # an invalidated capture may leave the pool taking this
                # stream's allocations: end that, and use a fresh pool
                with contextlib.suppress(Exception):
                    torch._C._cuda_endAllocateToPool(store.device.index,
                                                     store.pool)
                store.pool = torch.cuda.graph_pool_handle()
                raise
    if cs != ps:
        ps.wait_stream(cs)
    if not all(isinstance(x, torch.Tensor)
               for x in pytree.tree_leaves(out)):
        raise TypeError("the link returns a non-tensor leaf")
    static_in = [x for x in pytree.tree_leaves((s_kw, s_shared))
                 if isinstance(x, torch.Tensor)]
    return _LinkGraph(graph, static_in, out)


def _placed_link(mesh: Mesh, i: int, fn: Callable, static_kw: dict,
                 kw: dict, shared: dict) -> Any:
    """``_vmap_link`` of place ``i``'s shard, called inside ``mesh.on(i)``.

    On a CUDA place the call is a CUDA graph: the first call with a new
    key (:func:`_graph_key`) runs eagerly, which also warms up the kernel
    (its caches, its workspaces), and is then captured; later calls copy
    their inputs into the graph's static buffers and replay it, which runs
    the same kernels in the same order as eager, so values stay bit for
    bit. A link whose capture fails runs eagerly, now and on every later
    call of its key: counted in ``graph_refusals`` and logged once a key.
    The counts go to ``mesh.graph_stats``. CPU places are never graphed."""
    if mesh.devices[i].type != "cuda":
        return _vmap_link(fn, static_kw, kw, shared)
    stats = mesh.graph_stats
    key = _graph_key(fn, static_kw, kw, shared)
    if key is None:
        label = _kernel_label(fn)
        if label not in _unkeyed_logged:
            _unkeyed_logged.add(label)
            _log.warning("sharded link %s runs eagerly: its statics or "
                         "kwargs are unhashable, so no graph key", label)
        stats["graph_refusals"] += 1
        return _vmap_link(fn, static_kw, kw, shared)
    store = _place_graphs(mesh, i)
    ps = mesh.stream(i)
    with store.lock:
        entry = store.get(key)
        if isinstance(entry, _LinkGraph):
            stats["graph_replays"] += 1
            return entry.replay(
                [x for x in pytree.tree_leaves((kw, shared))
                 if isinstance(x, torch.Tensor)], ps, store.stream)
        out = _vmap_link(fn, static_kw, kw, shared)
        if entry is not None:            # refused before
            stats["graph_refusals"] += 1
            return out
        try:
            graph = _capture_link(store, ps, fn, static_kw, kw, shared)
        except Exception as exc:  # noqa: BLE001 - counted, logged, eager
            reason = f"{type(exc).__name__}: {exc}".splitlines()[0]
            store.put(key, reason)
            stats["graph_refusals"] += 1
            _log.warning("sharded link %s on %s runs eagerly: its CUDA "
                         "graph capture was refused (%s)",
                         _kernel_label(fn), mesh.places[i], reason)
            return out
        store.put(key, graph)
        stats["graph_captures"] += 1
        return out


def _sharded_segment(mesh: Mesh, plans: Sequence[_LinkPlan],
                     carry: Any) -> List[Any]:
    """:func:`_composed_segment` on every place, each on its own shard of
    the member axis, each link a graph on a CUDA place
    (:func:`_placed_link`): the carried intermediates stay on their place
    between links. Returns each link's output as a sharded pytree."""
    per_place = []
    for i in range(mesh.size):
        c = _local(carry, i)
        outs = []
        with mesh.on(i):
            for p in plans:
                stacked, shared = p.placed[i]
                kw = dict(stacked)
                if p.carry_name is not None:
                    kw[p.carry_name] = c
                c = _placed_link(mesh, i, p.fn,
                                 _place_statics(p.static_kw,
                                                mesh.devices[i]),
                                 kw, shared)
                outs.append(c)
        per_place.append(outs)
    return [mesh.merge([outs[k] for outs in per_place])
            for k in range(len(plans))]


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


def _wait(event: Any) -> None:
    """Wait for one dispatch's event, or for every place's of a sharded
    dispatch (a list: the join)."""
    if isinstance(event, list):
        for e in event:
            _wait(e)
    elif event is not None:
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

    A sharded output (:class:`~repro_torch.fusion.handles.ShardedValue`
    leaves, one completion event per place in ``events``) resolves shard
    by shard: asking for member ``i`` waits only on the event of the
    place that owns row ``i``, then copies that shard's mask and scalars.
    """

    def __init__(self, out: Any, n_live: int, check_finite: bool,
                 valid_lens: Optional[List[int]],
                 events: Optional[List[Any]] = None) -> None:
        self.leaves, self.treedef = pytree.tree_flatten(out)
        self.valid_lens = valid_lens
        self.padded_len = max(valid_lens) if valid_lens else None
        self.check_finite = check_finite
        self.n_live = n_live
        self.ok = np.ones(n_live, bool)
        self.host: Dict[int, np.ndarray] = {}
        sharded = next((leaf for leaf in self.leaves
                        if isinstance(leaf, ShardedValue)), None)
        self._bounds: List[Tuple[int, int]] = []
        if sharded is not None:
            self._bounds = [(start, int(t.shape[0]))
                            for start, t in sharded.shards]
            self._events = events or [None] * len(self._bounds)
            self._ready = [False] * len(self._bounds)
            for idx, leaf in enumerate(self.leaves):
                if leaf.ndim == 1:
                    self.host[idx] = np.empty(leaf.shape[0], dtype=object)
            return
        for idx, leaf in enumerate(self.leaves):
            arr = (leaf if isinstance(leaf, torch.Tensor)
                   else torch.as_tensor(np.asarray(leaf)))
            self.leaves[idx] = arr
            if arr.ndim == 1:
                self.host[idx] = arr.detach().cpu().numpy()
            if check_finite and arr.is_floating_point():
                fin = torch.isfinite(arr.reshape(arr.shape[0], -1)).all(dim=1)
                self.ok &= fin.cpu().numpy()[:n_live]

    def _ensure(self, i: int) -> None:
        """Resolve the shard that owns row ``i`` (sharded outputs only)."""
        if not self._bounds:
            return
        s = next(k for k, (start, rows) in enumerate(self._bounds)
                 if start <= i < start + rows)
        if self._ready[s]:
            return
        _wait(self._events[s])
        start, rows = self._bounds[s]
        live = max(0, min(rows, self.n_live - start))
        for idx, leaf in enumerate(self.leaves):
            t = leaf.local(s)
            if t.ndim == 1:
                self.host[idx][start:start + rows] = list(
                    t.detach().cpu().numpy())
            if self.check_finite and t.is_floating_point():
                fin = torch.isfinite(t.reshape(rows, -1)).all(dim=1)
                self.ok[start:start + live] &= fin.cpu().numpy()[:live]
        self._ready[s] = True

    def is_ok(self, i: int) -> bool:
        """Member ``i``'s outputs are finite (or not checked)."""
        self._ensure(i)
        return bool(self.ok[i])

    def member(self, i: int) -> Any:
        self._ensure(i)

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
# Single-link entry point (also the chain's per-stage degrade unit)
# --------------------------------------------------------------------------- #

def execute_fused(
    members: Sequence[Task],
    devices: Sequence[Any],
    cancel_event: threading.Event,
    deliver: Deliver,
    *,
    canceled: Optional[set] = None,
    fault_injector: Optional[Callable[[Task], bool]] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, int]:
    """Run ``members`` as one fused dispatch; deliver one completion each.

    Returns execution statistics (``fused`` / ``scalar_fallback`` /
    ``failed`` member counts). ``canceled`` uids are skipped without a
    completion (the same semantics as dropping a queued task on cancel);
    ``fault_injector`` is honoured per member so the failure experiments
    behave identically on the fused path. ``overrides`` (chain degrade)
    resolves future placeholders from the carrier's already-computed
    upstream values instead of the store.
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
        calls = [member_call(t, overrides) for t in live]
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
        return _scalar_fallback(live, cancel_event, finish, stats,
                                overrides=overrides)

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
                     finish, stats: Dict[str, int],
                     overrides: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, int]:
    """The batched dispatch raised (or could not be built): run each member
    on its own so only the actually-failing members fail."""
    for task in live:
        if cancel_event.is_set():
            finish(task, -2)
            continue
        try:
            fn, args, kwargs = member_call(task, overrides)
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
# Chain execution (async: dispatch on the carrier worker, drain elsewhere)
# --------------------------------------------------------------------------- #

class ChainExecution:
    """One micro-batch of members through L chain links, asynchronously.

    The carrier worker calls :meth:`dispatch` — resolve, stack, enqueue the
    composed device dispatches, recording one CUDA event after each and
    streaming one record per link — and returns. The RTS's completion
    drainer calls :meth:`drain`, which waits on each link's event in order
    and fans out the per-stage, per-member completions (the journal sees
    exactly the records a per-stage run would have produced, in the same
    order). A single-link "chain" is the plain fused micro-batch, just
    asynchronous.

    Degrade ladder: a failed composed dispatch at link *k* falls back to
    per-stage fused execution of links *k..L-1* (consuming the carrier's
    own upstream values — never the store, which mid-chain may not have
    been routed yet), and a failed per-stage dispatch falls back to
    per-member scalar execution (inside :func:`execute_fused`).

    Sharded tier: with ``mesh_devices`` that :func:`build_mesh` accepts,
    the stacked member kwargs split on the member axis, one shard per
    place (shared kwargs replicate), and every dispatch runs on each
    place's own shard under that place's device and stream — a composed
    segment's intermediates stay on their place between links. Each place
    records its own completion event; a member's fan-out waits only on the
    place that owns its row. Any failure of a sharded dispatch degrades
    through the same ladder, per-stage fused on one device, counted in
    ``degraded``.
    """

    def __init__(self, links: Sequence[Sequence[Task]],
                 devices: Sequence[Any],
                 cancel_event: threading.Event,
                 deliver: Deliver,
                 *,
                 canceled: Optional[set] = None,
                 fault_injector: Optional[Callable[[Task], bool]] = None,
                 compose: bool = True,
                 mesh_devices: Optional[Sequence[Any]] = None) -> None:
        self.links: List[List[Task]] = [list(link) for link in links]
        self.compose = compose
        self.devices = devices
        self.cancel_event = cancel_event
        self.deliver = deliver
        self.canceled = canceled if canceled is not None else set()
        self.fault_injector = fault_injector
        self.started = time.time()
        self._mesh = build_mesh(mesh_devices)
        self.tier = ("shard" if self._mesh is not None
                     else "chain" if len(self.links) > 1 else "fused")
        self.stats = {"fused": 0, "scalar_fallback": 0, "failed": 0,
                      "dispatches": 0, "chain_links": 0,
                      "sharded_dispatches": 0, "degraded": 0,
                      **dict.fromkeys(GRAPH_STATS, 0)}
        self._plans: List[Optional[_LinkPlan]] = [None] * len(self.links)
        self._injected: Dict[int, int] = {}   # member col -> first bad link
        self._fail_retryable: Dict[int, bool] = {}
        self._records: deque = deque()
        self._cv = threading.Condition()
        self._delivered: set = set()
        self._fail_link = 0

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

    def _emit(self, outs: Sequence[Tuple[int, Any]]) -> None:
        """Stream one dispatch's link outputs to the drainer, each with the
        CUDA event recorded right after that dispatch's last enqueue (under
        a mesh: one event per place, and the dispatch counts as sharded)."""
        if self._mesh is not None:
            event = self._mesh.events()
            self.stats["sharded_dispatches"] += 1
            self.stats.update(self._mesh.graph_stats)
        else:
            event = _completion_event([out for _, out in outs])
        t_dispatch = time.perf_counter()
        self.stats["dispatches"] += 1
        for k, out in outs:
            plan = self._plans[k]
            if plan is not None:          # a reduce node has no plan
                plan.t_dispatch = t_dispatch
            self._push(("link", k, out, event))

    # -- delivery --------------------------------------------------------- #

    def _finish(self, task: Task, exit_code: int, result: Any = None,
                exception: Optional[str] = None, n_live: int = 1,
                pilot_lost: bool = False) -> None:
        drop_member_call(task.uid)   # before the cancel skip: see finish()
        if task.uid in self.canceled or task.uid in self._delivered:
            return
        self._delivered.add(task.uid)
        now = time.time()
        if exit_code == 1 and not pilot_lost:
            self.stats["failed"] += 1
        self.deliver(TaskCompletion(
            uid=task.uid, exit_code=exit_code, result=result,
            exception=exception, started_at=self.started, completed_at=now,
            execution_seconds=(now - self.started) / max(1, n_live),
            pilot_lost=pilot_lost))

    def _deliver_once(self, outcomes: Dict[str, TaskCompletion]
                      ) -> Deliver:
        """A deliver for the degrade path's sub-executions: records every
        outcome, delivers each member at most once."""
        def dl(c: TaskCompletion) -> None:
            outcomes[c.uid] = c
            if c.uid in self.canceled or c.uid in self._delivered:
                return
            self._delivered.add(c.uid)
            self.deliver(c)
        return dl

    # -- worker side ------------------------------------------------------ #

    def dispatch(self) -> None:
        """Resolve inputs, stack, and enqueue every link's device dispatch.

        Never raises: a preparation/dispatch failure at link *k* streams a
        ``degrade`` record so the drainer falls back for links *k..L-1*
        after fanning out the links that did dispatch.
        """
        try:
            if CARRIER_FAULT is not None and CARRIER_FAULT(self):
                raise RuntimeError("injected carrier fault (chaos plane)")
            self._dispatch_links()
        except Exception:  # noqa: BLE001 - drainer owns the fallback
            self._push(("degrade", self._fail_link,
                        traceback.format_exc(limit=10)))
        self._push(("end",))

    def _dispatch_links(self) -> None:
        if not self.links or not self.links[0]:
            return
        if self.cancel_event.is_set():
            self._push(("canceled",))
            return
        # fault injection is a per-member, per-link contract: the first
        # injected link fails the member there and poisons its downstream
        for k, tasks in enumerate(self.links):
            for m, t in enumerate(tasks):
                if (self.fault_injector is not None and m not in self._injected
                        and self.fault_injector(t)):
                    self._injected[m] = k
        if not self.compose and len(self.links) > 1:
            # composition declined (fusion_min_chain at the RTS): run the
            # links per-stage fused INSIDE the carrier — the carrier still
            # owns the ordering, so link k+1 never races link k's routing
            self._push(("degrade", 0, None))
            return
        self._fail_link = 0
        mesh = self._mesh
        device = (_lease_device(self.devices) if mesh is None
                  else mesh.devices[0])
        entry_calls = [member_call(t) for t in self.links[0]]
        # a sharded batch pads to equal pow2 shards, one per place
        entry_pad = None if mesh is None \
            else shard_pad(len(entry_calls), mesh.size)
        fn, spec, static_kw, shared_kw, stacked, valid_lens, padded_b = \
            _prepare(entry_calls, device, pad_to=entry_pad)
        self._plans[0] = _LinkPlan(self.links[0], fn, spec, static_kw,
                                   shared_kw, stacked, valid_lens, None,
                                   padded_b)
        prev = self.links[0]
        inherited = valid_lens
        for j, tasks in enumerate(self.links[1:], start=1):
            self._fail_link = j
            calls, carry_name = _continuation_calls(tasks, prev)
            fnj, specj, st_kw, sh_kw, stk, vl, _ = _prepare(
                calls, device, pad_to=padded_b)
            if vl is None:
                # a padded axis rides the carry through the whole chain:
                # downstream links inherit the entry's per-member lengths so
                # their delivered values trim exactly like the scalar path's
                vl = inherited
            else:
                inherited = vl
            self._plans[j] = _LinkPlan(tasks, fnj, specj, st_kw, sh_kw, stk,
                                       vl, carry_name, padded_b)
            prev = tasks
        if mesh is not None:
            self._place_plans()
        # dispatch: maximal runs of vmap-able links compose into ONE
        # segment; a hand-written batched impl executes eagerly between
        # segments (its ops still enqueue asynchronously on the device).
        # Under a mesh every dispatch runs on each place's shard.
        idx = 0
        carry = None
        while idx < len(self._plans):
            self._fail_link = idx
            plan = self._plans[idx]
            if plan.spec.batched is not None:
                if mesh is not None:
                    carry = self._sharded_batched(plan, carry)
                else:
                    kw = dict(plan.stacked)
                    if plan.carry_name is not None:
                        kw[plan.carry_name] = carry
                    carry = plan.spec.batched(**kw, **plan.static_kw,
                                              **plan.shared_kw)
                self._emit([(idx, carry)])
                idx += 1
                continue
            j = idx
            while (j < len(self._plans)
                   and self._plans[j].spec.batched is None):
                j += 1
            if mesh is not None:
                outs = _sharded_segment(mesh, self._plans[idx:j], carry)
            else:
                outs = _composed_segment(self._plans[idx:j], carry)
            self._emit(list(enumerate(outs, start=idx)))
            carry = outs[-1]
            idx = j

    def _place_plans(self) -> None:
        """Split every link's stacked kwargs on the member axis, one equal
        shard per place, and replicate its shared kwargs to every place.
        Raises on an unplaceable plan — caught by :meth:`dispatch`, which
        degrades to the micro-batch ladder."""
        mesh = self._mesh
        for plan in self._plans:
            if plan is None:             # a reduce node has no plan
                continue
            if plan.padded_b % mesh.size:
                raise Incongruent(f"{plan.padded_b} rows do not split over "
                                  f"{mesh.size} places")
            per = plan.padded_b // mesh.size
            plan.placed = [
                ({k: mesh.put(v.narrow(0, i * per, per), i)
                  for k, v in plan.stacked.items()},
                 pytree.tree_map(lambda v, i=i: mesh.put(v, i),
                                 plan.shared_kw))
                for i in range(mesh.size)]
        mesh.follow_leader()

    def _sharded_batched(self, plan: _LinkPlan, carry: Any,
                         bcast_name: Optional[str] = None,
                         bcasts: Optional[List[Any]] = None) -> Any:
        """Run a hand-batched kernel on each place's member shard, inside
        the place's device and stream context and with the place's device
        as its ``device`` static (the kernel's own tiling applies per
        shard); a DAG broadcast arrives as one copy per place."""
        mesh = self._mesh
        outs = []
        for i in range(mesh.size):
            stacked, shared = plan.placed[i]
            kw = dict(stacked)
            if plan.carry_name is not None:
                kw[plan.carry_name] = _local(carry, i)
            if bcast_name is not None:
                shared = dict(shared)
                shared[bcast_name] = bcasts[i]
            with mesh.on(i):
                outs.append(plan.spec.batched(
                    **kw, **_place_statics(plan.static_kw, mesh.devices[i]),
                    **shared))
        return mesh.merge(outs)

    # -- drainer side ----------------------------------------------------- #

    def drain(self, stop_event: Optional[threading.Event] = None
              ) -> Dict[str, int]:
        """Wait through the link records in order, fanning out per-stage,
        per-member completions; returns the accumulated statistics.

        Member state is sized to the highest member column (widths change
        across a DAG's fan-in, and resumed DAG fragments can hold sparse
        columns); ``_fail_retryable`` maps a member column to True when its
        failing link still had retry budget. Its downstream links then
        requeue through the pilot_lost channel (FAILED without a budget
        charge) instead of failing permanently, so the upstream retry
        re-runs the member's whole chain suffix — the outcome the per-stage
        gated path would have produced."""
        ok = np.ones(self._width(), bool)
        fail_reason: Dict[int, str] = {}
        overrides: Dict[str, Any] = {}
        fanned = 0
        degraded = False
        while True:
            rec = self._pop(stop_event)
            if rec is None:        # RTS stopping: abandon without fabricating
                return self.stats
            kind = rec[0]
            if kind == "link":
                _, k, out, event = rec
                if degraded:
                    continue       # already handled by the fallback
                if not self._fan_link(k, out, event, ok, fail_reason,
                                      overrides):
                    degraded = True
                    fanned = len(self.links)
                else:
                    fanned = k + 1
            elif kind == "degrade":
                _, start, exc = rec
                if not degraded:
                    if exc is not None:
                        # a real dispatch failure (not a declined
                        # composition): the breaker board keys on this
                        self.stats["degraded"] += 1
                    self._degrade(max(start, fanned), ok, fail_reason,
                                  overrides)
                    degraded = True
                    fanned = len(self.links)
            elif kind == "canceled":
                for tasks in self.links:
                    for t in tasks:
                        self._finish(t, -2)
                fanned = len(self.links)
            elif kind == "end":
                break
        if fanned < len(self.links):
            # the worker ended early without a degrade record (engine bug
            # guard): fall back for whatever never dispatched
            self._degrade(fanned, ok, fail_reason, overrides)
        return self.stats

    def _width(self) -> int:
        return len(self.links[0]) if self.links and self.links[0] else 0

    def _resolve(self, k: int, out: Any,
                 event: Optional["torch.cuda.Event"]) -> Optional["_FanOut"]:
        """Wait for link ``k``'s dispatch and build its fan-out; None ⇒ an
        asynchronous device error surfaced, the caller degrades."""
        plan = self._plans[k]
        sharded = isinstance(event, list)
        try:
            if not sharded:              # a sharded fan-out waits by shard
                _wait(event)
            if plan.t_dispatch is not None:
                tel.observe_dispatch(_kernel_label(plan.fn), self.tier,
                                     time.perf_counter() - plan.t_dispatch)
            return _FanOut(out, len(self.links[k]), plan.spec.check_finite,
                           plan.valid_lens if plan.spec.trim_outputs
                           else None, events=event if sharded else None)
        except Exception:  # noqa: BLE001 - degrade this link and the rest
            return None

    def _fan_link(self, k: int, out: Any,
                  event: Optional["torch.cuda.Event"], ok: np.ndarray,
                  fail_reason: Dict[int, str],
                  overrides: Dict[str, Any]) -> bool:
        """Wait for link ``k``'s output and fan it out; False ⇒ resolving
        failed and the remaining links were degraded."""
        tasks = self.links[k]
        n = len(tasks)
        fan = self._resolve(k, out, event)
        if fan is None:
            self.stats["degraded"] += 1
            self._degrade(k, ok, fail_reason, overrides)
            return False
        if len(self.links) > 1:
            self.stats["chain_links"] += 1
        try:
            for i, task in enumerate(tasks):
                if self.cancel_event.is_set():
                    self._finish(task, -2)
                    continue
                if not ok[i]:
                    self._finish(task, 1, exception=fail_reason.get(
                        i, "upstream chain member failed"), n_live=n,
                        pilot_lost=self._fail_retryable.get(i, False))
                    continue
                if self._injected.get(i) == k:
                    self._fail(ok, fail_reason, i, task, k, "injected fault",
                               n)
                    continue
                if not fan.is_ok(i):
                    self._fail(ok, fail_reason, i, task, k,
                               "non-finite output", n)
                    continue
                value = fan.member(i)
                overrides[task.name] = value
                self._finish(task, 0, result=value, n_live=n)
                self.stats["fused"] += 1
        except Exception:  # noqa: BLE001 - a shard's wait failed: degrade
            self.stats["degraded"] += 1
            self._degrade(k, ok, fail_reason, overrides)
            return False
        return True

    def _fail(self, ok: np.ndarray, fail_reason: Dict[int, str], col: int,
              task: Task, k: int, why: str, n: int,
              where: str = "chain member failed at link") -> None:
        """Fail member ``col`` at link ``k`` (an injected fault or a
        non-finite output) and mark its downstream links to fail with it."""
        ok[col] = False
        fail_reason[col] = f"upstream {where} {k} ({why})"
        self._fail_retryable[col] = task.retries < task.max_retries
        self._finish(task, 1, n_live=n, exception=(
            "injected fault" if why == "injected fault" else
            f"non-finite values in fused dispatch output (member {task.name})"))

    def _degrade(self, start: int, ok: np.ndarray,
                 fail_reason: Dict[int, str],
                 overrides: Dict[str, Any]) -> None:
        """Per-stage fused fallback for links ``start..L-1``, in link order,
        resolving carried inputs from ``overrides`` (this carrier's own
        fanned-out values) so the fallback can never race the store."""
        for k in range(start, len(self.links)):
            tasks = self.links[k]
            n = len(tasks)
            todo: List[Tuple[int, Task]] = []
            for i, task in enumerate(tasks):
                if self.cancel_event.is_set():
                    self._finish(task, -2)
                    continue
                if not ok[i]:
                    self._finish(task, 1, exception=fail_reason.get(
                        i, "upstream chain member failed"), n_live=n,
                        pilot_lost=self._fail_retryable.get(i, False))
                    continue
                if self._injected.get(i) == k:
                    self._fail(ok, fail_reason, i, task, k, "injected fault",
                               n)
                    continue
                todo.append((i, task))
            self._run_stage(k, todo, ok, fail_reason, overrides,
                            f"upstream chain member failed at link {k}")

    def _run_stage(self, k: int, todo: List[Tuple[int, Task]],
                   ok: np.ndarray, fail_reason: Dict[int, str],
                   overrides: Dict[str, Any], reason: str) -> None:
        """One link's remaining members through :func:`execute_fused`
        (then per-member scalar); successes feed ``overrides``, failures
        poison the member's downstream links."""
        if not todo:
            return
        outcomes: Dict[str, TaskCompletion] = {}
        sub = execute_fused(
            [t for _, t in todo], self.devices, self.cancel_event,
            self._deliver_once(outcomes), canceled=self.canceled,
            fault_injector=None, overrides=overrides)
        for key in ("fused", "scalar_fallback", "failed", "dispatches"):
            self.stats[key] += sub.get(key, 0)
        for col, task in todo:
            c = outcomes.get(task.uid)
            if c is not None and c.exit_code == 0:
                ok[col] = True
                overrides[task.name] = c.result
            elif c is None or c.exit_code != -2:
                ok[col] = False
                fail_reason[col] = reason
                self._fail_retryable[col] = task.retries < task.max_retries


# --------------------------------------------------------------------------- #
# DAG execution (fan-in reductions + fan-out broadcasts, one carrier)
# --------------------------------------------------------------------------- #

def _apply_reduction(stacked: Any, mask: np.ndarray, kind: Optional[str],
                     combine: Optional[Callable[..., Any]]) -> Any:
    """Masked device-side reduction of one ensemble node's stacked output.

    ``mask`` is the ``(B,)`` bool vector of live members known host-side
    (bucket padding rows and injected faults); per-member finiteness is
    folded in HERE, on the device, so a poisoned member drops out of the
    reduction without a host sync — the survivors' reduction succeeds
    while the poisoned member fails alone at its own node's fan-out.

    Kinds reduce over EVERY axis of the valid members' values — the
    list-of-values semantics of ``np.sum([...])`` / ``np.max([...])`` —
    and an empty valid set yields NaN so the reduce task fails rather
    than fabricating an identity element. It is the sharded tier's
    reduction over a single place: the rows' partials
    (:func:`_reduction_partials`), combined (:func:`_combine_partials`).
    """
    valid = _valid_rows(stacked, mask)
    if combine is not None:
        return combine(stacked, valid)
    return _combine_partials([_reduction_partials(stacked, valid, kind)],
                             kind, _per_member(stacked))


def _valid_rows(stacked: Any, mask: np.ndarray) -> torch.Tensor:
    """The host mask folded with every floating leaf's per-member
    finiteness (on the leaves' device)."""
    leaves = pytree.tree_leaves(stacked)
    device = leaves[0].device if leaves else torch.device("cpu")
    valid = torch.as_tensor(mask, dtype=torch.bool, device=device)
    for leaf in leaves:
        if leaf.is_floating_point():
            valid = valid & torch.isfinite(
                leaf.reshape(leaf.shape[0], -1)).all(dim=1)
    return valid


def _per_member(stacked: Any) -> List[int]:
    """Each leaf's element count per member (the ``mean`` divisor)."""
    return [int(np.prod(leaf.shape[1:])) if leaf.ndim > 1 else 1
            for leaf in pytree.tree_leaves(stacked)]


def _reduction_partials(stacked: Any, valid: torch.Tensor,
                        kind: str) -> Tuple[torch.Tensor, Any]:
    """One place's part of a reduction over its rows: the count of valid
    members and, per leaf, the masked sum (``sum``/``mean``), min or max,
    on the rows' device."""
    def part(leaf: torch.Tensor) -> torch.Tensor:
        m = valid.reshape((-1,) + (1,) * (leaf.ndim - 1))
        if kind in ("sum", "mean"):
            return torch.where(m, leaf, 0).sum()
        if leaf.is_floating_point():
            neutral = float("inf") if kind == "min" else float("-inf")
        else:
            info = torch.iinfo(leaf.dtype)
            neutral = info.max if kind == "min" else info.min
        masked = torch.where(m, leaf, neutral)
        return masked.min() if kind == "min" else masked.max()

    return valid.sum(), pytree.tree_map(part, stacked)


def _combine_partials(partials: Sequence[Tuple[torch.Tensor, Any]],
                      kind: str, per_member: Sequence[int]) -> Any:
    """The places' partials combined in place order (so the result is the
    same on every run): counts and sums add, minima and maxima take the
    extreme; ``mean`` divides by the valid members' element count, and an
    empty valid set gives NaN."""
    nvalid = partials[0][0]
    for count, _ in partials[1:]:
        nvalid = nvalid + count
    flat = [pytree.tree_flatten(p)[0] for _, p in partials]
    treedef = pytree.tree_flatten(partials[0][1])[1]
    out = []
    for idx, size in enumerate(per_member):
        val = flat[0][idx]
        for leaves in flat[1:]:
            if kind in ("sum", "mean"):
                val = val + leaves[idx]
            elif kind == "min":
                val = torch.minimum(val, leaves[idx])
            else:
                val = torch.maximum(val, leaves[idx])
        if kind == "mean":
            val = val / (nvalid * size)
        if val.is_floating_point():
            val = torch.where(nvalid > 0, val, float("nan"))
        out.append(val)
    return pytree.tree_unflatten(out, treedef)


def _reduce_host(leaf: Any) -> Any:
    """Host-side form of one reduced leaf: Python scalar for 0-d values
    (what a ``float(np.sum([...]))`` scalar reducer returns), ndarray
    otherwise."""
    arr = to_host(leaf)
    return arr.item() if arr.ndim == 0 else arr


def _dag_continuation_calls(tasks: Sequence[Task],
                            prev_tasks: Optional[Sequence[Task]],
                            carry_name: Optional[str],
                            bcast_name: Optional[str],
                            bcast_source: Optional[str]
                            ) -> List[Tuple[Callable, list, dict]]:
    """Resolve a DAG ensemble node's members WITHOUT touching the carried
    or broadcast inputs — both arrive device-resident inside the composed
    segment. Unlike the chain's :func:`_continuation_calls` there is no
    inference: the compiler's tags name the edge kwargs, so the
    ``carry_name`` kwarg must hold the aligned previous member's future and
    the ``bcast_name`` kwarg the source reduction's future; any other
    future is foreign to the DAG and refuses composition."""
    from ..api.runtime import FUTURE_KEY
    from ..api.runtime import resolve as resolve_placeholders

    calls: List[Tuple[Callable, list, dict]] = []
    for i, t in enumerate(tasks):
        if t.executable != TRAMPOLINE:
            raise Incongruent("DAG node is not a data-flow task")
        if t.kwargs.get("__args__"):
            raise Incongruent("DAG node has positional args")
        ns = t.kwargs["__ns__"]
        fn = resolve_executable(t.kwargs["__fn__"])
        other: Dict[str, Any] = {}
        for k, v in (t.kwargs.get("__kwargs__") or {}).items():
            if isinstance(v, dict) and set(v) == {FUTURE_KEY}:
                name = v[FUTURE_KEY]
                if (carry_name is not None and k == carry_name
                        and prev_tasks is not None
                        and name == prev_tasks[i].name):
                    continue
                if (bcast_name is not None and k == bcast_name
                        and name == bcast_source):
                    continue
                raise Incongruent("DAG node consumes a foreign future")
            other[k] = _unwrap(resolve_placeholders(v, ns))
        calls.append((fn, [], other))
    return calls


class _DagNodeMeta:
    """Per-node routing parsed from the ``_fusion_dag`` tags: role, edge
    kwarg names, and the reduction semantics of ``"r"`` nodes (``combine``
    is resolved lazily at dispatch time from the reduce task's kernel)."""

    __slots__ = ("role", "carry_name", "bcast_name", "kind", "combine")

    def __init__(self, role: str, carry_name: Optional[str],
                 bcast_name: Optional[str], kind: Optional[str]) -> None:
        self.role = role
        self.carry_name = carry_name
        self.bcast_name = bcast_name
        self.kind = kind
        self.combine: Optional[Callable[..., Any]] = None


class DagExecution(ChainExecution):
    """One whole fused DAG — ``ensemble → then → gather → broadcast →
    ensemble`` — through one carrier, asynchronously.

    ``links`` holds one aligned task list per DAG *node* in node order:
    ensemble nodes their member tasks (width w), reduction nodes exactly
    one reduce task. Roles and edge kwargs come from the ``_fusion_dag``
    tags the compiler stamped. The dispatcher composes maximal runs of
    traceable nodes — ensemble nodes without a hand-batched impl, plus
    every reduction node — into single segments threading the
    member-stacked ``carry`` and the unbatched ``bcast`` (the last
    reduction's output) between nodes as device tensors; a hand-batched
    ensemble node executes eagerly between segments with both values
    staying on the device. A diamond (``A → reduce → B`` with an
    elementwise ``A → B`` carry) therefore runs as ONE dispatch.

    Reductions execute masked (:func:`_apply_reduction`): padding and
    injected faults are excluded host-side, non-finite members on the
    device, so a poisoned member fails alone at its node while the
    reduction succeeds over the survivors; a reduction with NO live
    members (or a genuinely non-finite result) FAILS, and every downstream
    broadcast consumer fails with an upstream marker. On the sharded tier
    the same nodes run on every place's member shard: ensemble nodes stay
    split on the member axis, and a reduction gathers each place's partials
    (count, and the masked sum, min or max) to the leader, which combines
    them in place order and copies the result back to every place for the
    broadcast into the next ensemble node. A custom combine sees only its
    own shard, so it refuses the mesh.

    Degrade ladder: any preparation or dispatch failure falls back to
    sequential per-node execution INSIDE the carrier — per-stage fused
    ensembles (then per-member scalar, inside :func:`execute_fused`) and
    *scalar* reductions resolving member values from the carrier's own
    overrides, with store-parity semantics: a scalar reduce over a failed
    member is a failed reduce, exactly like the un-fused gather path.
    """

    def __init__(self, links: Sequence[Sequence[Task]],
                 devices: Sequence[Any],
                 cancel_event: threading.Event,
                 deliver: Deliver,
                 *,
                 canceled: Optional[set] = None,
                 fault_injector: Optional[Callable[[Task], bool]] = None,
                 compose: bool = True,
                 mesh_devices: Optional[Sequence[Any]] = None) -> None:
        super().__init__(links, devices, cancel_event, deliver,
                         canceled=canceled, fault_injector=fault_injector,
                         compose=compose, mesh_devices=mesh_devices)
        self.tier = "dag-shard" if self._mesh is not None else "dag"
        self.stats["dag_links"] = 0
        self._meta: List[_DagNodeMeta] = []
        self._cols: List[List[int]] = []
        for tasks in self.links:
            tag = (parse_dag_tag(tasks[0].tags) if tasks else None) or {}
            self._meta.append(_DagNodeMeta(
                tag.get("r", "e"), tag.get("a"), tag.get("b"),
                tag.get("rk")))
            # member COLUMN of each task: a resumed fragment's node list
            # can be partial, so list position and member index diverge —
            # per-member state (ok / injected / retryable) keys on the
            # tag's member index, which aligns columns across nodes
            cols = []
            for i, t in enumerate(tasks):
                tg = parse_dag_tag(t.tags)
                cols.append(tg["m"] if tg else i)
            self._cols.append(cols)
        self._masks: List[Optional[np.ndarray]] = [None] * len(self.links)
        self._injected_reduce: set = set()   # node index of injected "r"
        self._bcast_ok = True
        self._bcast_reason: Optional[str] = None
        self._bcast_retryable = False

    def _width(self) -> int:
        return max((max(c) + 1 for c in self._cols if c), default=1)

    # -- worker side ------------------------------------------------------ #

    def _dispatch_links(self) -> None:
        if not self.links or not self.links[0]:
            return
        if self.cancel_event.is_set():
            self._push(("canceled",))
            return
        # injection: ensemble members key by member COLUMN (first injected
        # node wins, downstream poisons); a reduce node keys by NODE index
        # so its single task cannot collide with member 0's column
        for k, tasks in enumerate(self.links):
            if self._meta[k].role == "r":
                if (self.fault_injector is not None and tasks
                        and self.fault_injector(tasks[0])):
                    self._injected_reduce.add(k)
                continue
            for i, t in enumerate(tasks):
                col = self._cols[k][i]
                if (self.fault_injector is not None
                        and col not in self._injected
                        and self.fault_injector(t)):
                    self._injected[col] = k
        self._fail_link = 0
        if not self.compose:
            # composition declined (dag knob off at the RTS): sequential
            # per-node INSIDE the carrier — the carrier still owns the
            # ordering, so the reduce never races its members' routing
            self._push(("degrade", 0, None))
            return
        self._prepare_nodes()
        mesh = self._mesh
        if mesh is not None:
            self._place_plans()
        idx = 0
        carry = None
        bcast = None        # under a mesh: one copy per place
        n = len(self.links)
        while idx < n:
            self._fail_link = idx
            meta = self._meta[idx]
            plan = self._plans[idx]
            if meta.role == "e" and plan.spec.batched is not None:
                if mesh is not None:
                    carry = self._sharded_batched(plan, carry,
                                                  meta.bcast_name, bcast)
                else:
                    kw = dict(plan.stacked)
                    if meta.carry_name is not None:
                        kw[meta.carry_name] = carry
                    shared = dict(plan.shared_kw)
                    if meta.bcast_name is not None:
                        shared[meta.bcast_name] = bcast
                    carry = plan.spec.batched(**kw, **plan.static_kw,
                                              **shared)
                self._emit([(idx, carry)])
                idx += 1
                continue
            j = idx
            while j < n and not (self._meta[j].role == "e"
                                 and self._plans[j].spec.batched
                                 is not None):
                j += 1
            if mesh is not None:
                outs, bcasts = self._sharded_dag_segment(idx, j, carry,
                                                         bcast)
            else:
                outs = self._dag_segment(idx, j, carry, bcast)
            self._emit(list(enumerate(outs, start=idx)))
            for k, out in enumerate(outs, start=idx):
                if self._meta[k].role == "e":
                    carry = out
                else:
                    bcast = out
            if mesh is not None and bcasts is not None:
                bcast = bcasts
            idx = j

    def _prepare_nodes(self) -> None:
        """Build every node's plan, reduction mask and combine; raises
        :class:`Incongruent` on any unsupported shape — caught by
        :meth:`dispatch`, which degrades the WHOLE DAG to sequential
        per-node execution (prep happens before any dispatch)."""
        if self._meta[0].role != "e":
            raise Incongruent("DAG does not start at an ensemble node")
        mesh = self._mesh
        if mesh is not None:
            widths = {len(t) for t, mt in zip(self.links, self._meta)
                      if mt.role == "e"}
            if len(widths) != 1:
                raise Incongruent("sharded DAG requires equal node widths")
        device = (_lease_device(self.devices) if mesh is None
                  else mesh.devices[0])
        entry_calls = [member_call(t) for t in self.links[0]]
        entry_pad = None if mesh is None else shard_pad(
            len(entry_calls), mesh.size)
        fn, spec, static_kw, shared_kw, stacked, valid_lens, padded_b = \
            _prepare(entry_calls, device, pad_to=entry_pad)
        self._plans[0] = _LinkPlan(self.links[0], fn, spec, static_kw,
                                   shared_kw, stacked, valid_lens, None,
                                   padded_b)
        pad_of = {0: padded_b}       # e-node index -> padded batch axis
        lens_of = {0: valid_lens}    # e-node index -> row-pad lengths
        last_e = 0
        last_r_name: Optional[str] = None
        for k in range(1, len(self.links)):
            meta = self._meta[k]
            tasks = self.links[k]
            if meta.role == "r":
                if len(tasks) != 1:
                    raise Incongruent("reduction node must have one task")
                meta.combine = self._reduce_combine(k)
                if meta.combine is not None and mesh is not None:
                    raise Incongruent(
                        "custom combine cannot run on the sharded tier")
                if meta.combine is None and meta.kind is None:
                    raise Incongruent("reduction node lost its kind")
                if lens_of.get(last_e) is not None and (
                        meta.combine is not None
                        or meta.kind not in ("max", "min")):
                    # edge-replicated pad ROWS inside a member duplicate
                    # real values: harmless under max/min, wrong in a sum
                    raise Incongruent(
                        "row-padded member values only reduce safely "
                        "under max/min")
                self._masks[k] = self._node_mask(last_e, pad_of[last_e])
                last_r_name = tasks[0].name
                continue
            if meta.bcast_name is not None and last_r_name is None:
                raise Incongruent("broadcast precedes any reduction")
            calls = _dag_continuation_calls(
                tasks,
                self.links[last_e] if meta.carry_name is not None else None,
                meta.carry_name, meta.bcast_name, last_r_name)
            if (meta.carry_name is not None
                    and len(tasks) != len(self.links[last_e])):
                raise Incongruent("carry nodes disagree on member count")
            if meta.carry_name is not None:
                pad_to: Optional[int] = pad_of[last_e]
            else:
                pad_to = None if mesh is None else shard_pad(
                    len(tasks), mesh.size)
            fnk, speck, st_kw, sh_kw, stk, vl, pb = _prepare(
                calls, device, pad_to=pad_to)
            if vl is None and meta.carry_name is not None:
                vl = lens_of[last_e]   # padded rows ride the carry through
            self._plans[k] = _LinkPlan(tasks, fnk, speck, st_kw, sh_kw,
                                       stk, vl, meta.carry_name, pb)
            last_e = k
            pad_of[k] = pb
            lens_of[k] = vl

    def _reduce_combine(self, k: int) -> Optional[Callable[..., Any]]:
        task = self.links[k][0]
        if task.executable == TRAMPOLINE:
            fn = resolve_executable(task.kwargs["__fn__"])
        else:
            fn = task.resolve()
        spec = reduction_spec(fn)
        if spec is None:
            raise Incongruent("reduction node lost its fusable marker")
        return spec.combine

    def _node_mask(self, src: int, padded_b: int) -> np.ndarray:
        """Host-known live mask over the source node's padded member axis:
        bucket pad rows off, injected members at or before the source node
        off (their poison reaches the reduced values)."""
        mask = np.zeros(padded_b, bool)
        for i, col in enumerate(self._cols[src]):
            k_inj = self._injected.get(col)
            mask[i] = k_inj is None or k_inj > src
        return mask

    def _dag_segment(self, start: int, stop: int, carry: Any,
                     bcast: Any) -> List[Any]:
        """Nodes ``[start, stop)`` back to back — ensemble nodes under
        ``vmap``, reduction nodes reduced — with carry and bcast threaded
        between them as device tensors (one dispatch for the run)."""
        outs = []
        for k in range(start, stop):
            meta = self._meta[k]
            if meta.role == "r":
                bcast = _apply_reduction(carry, self._masks[k], meta.kind,
                                         meta.combine)
                outs.append(bcast)
                continue
            plan = self._plans[k]
            kw = dict(plan.stacked)
            if meta.carry_name is not None:
                kw[meta.carry_name] = carry
            shared = dict(plan.shared_kw)
            if meta.bcast_name is not None:
                shared[meta.bcast_name] = bcast
            carry = _vmap_link(plan.fn, plan.static_kw, kw, shared)
            outs.append(carry)
        return outs

    def _sharded_dag_segment(self, start: int, stop: int, carry: Any,
                             bcasts: Optional[List[Any]]
                             ) -> Tuple[List[Any], Optional[List[Any]]]:
        """:meth:`_dag_segment` on every place's member shard, node by node
        (a reduction is a barrier across places). Returns the nodes'
        outputs — ensemble nodes sharded, reductions the leader's value —
        and the last reduction's copy on every place."""
        mesh = self._mesh
        carries = [_local(carry, i) for i in range(mesh.size)]
        outs = []
        for k in range(start, stop):
            meta = self._meta[k]
            if meta.role == "r":
                result, bcasts = self._sharded_reduction(k, carries)
                outs.append(result)
                continue
            plan = self._plans[k]
            for i in range(mesh.size):
                stacked, shared = plan.placed[i]
                kw = dict(stacked)
                if meta.carry_name is not None:
                    kw[meta.carry_name] = carries[i]
                shared = dict(shared)
                if meta.bcast_name is not None:
                    shared[meta.bcast_name] = bcasts[i]
                with mesh.on(i):
                    carries[i] = _placed_link(
                        mesh, i, plan.fn,
                        _place_statics(plan.static_kw, mesh.devices[i]),
                        kw, shared)
            outs.append(mesh.merge(carries))
        return outs, bcasts

    def _sharded_reduction(self, k: int, carries: List[Any]
                           ) -> Tuple[Any, List[Any]]:
        """Node ``k``'s reduction across the mesh: every place reduces its
        rows (its slice of the host mask) to partials on its own stream,
        the leader's stream waits for them and combines in place order, and
        every place's stream waits for the leader before taking its copy of
        the result."""
        mesh = self._mesh
        meta = self._meta[k]
        mask = self._masks[k]
        partials = []
        start = 0
        for i in range(mesh.size):
            rows = int(pytree.tree_leaves(carries[i])[0].shape[0])
            with mesh.on(i):
                valid = _valid_rows(carries[i], mask[start:start + rows])
                partials.append(_reduction_partials(carries[i], valid,
                                                    meta.kind))
            start += rows
        done = mesh.events()
        with mesh.on(0):
            if done is not None:
                for event in done[1:]:
                    mesh.stream(0).wait_event(event)
            moved = [pytree.tree_map(lambda t: mesh.put(t, 0), p)
                     for p in partials]
            result = _combine_partials(moved, meta.kind,
                                       _per_member(carries[0]))
        combined = mesh.events()
        bcasts = []
        for i in range(mesh.size):
            with mesh.on(i):
                if combined is not None and i:
                    mesh.stream(i).wait_event(combined[0])
                bcasts.append(pytree.tree_map(lambda t: mesh.put(t, i),
                                              result))
        return result, bcasts

    # -- drainer side ----------------------------------------------------- #

    def _fan_link(self, k: int, out: Any,
                  event: Optional["torch.cuda.Event"], ok: np.ndarray,
                  fail_reason: Dict[int, str],
                  overrides: Dict[str, Any]) -> bool:
        if self._meta[k].role == "r":
            return self._fan_reduce(k, out, event, ok, fail_reason,
                                    overrides)
        meta = self._meta[k]
        tasks = self.links[k]
        n = len(tasks)
        fan = self._resolve(k, out, event)
        if fan is None:
            self.stats["degraded"] += 1
            self._degrade(k, ok, fail_reason, overrides)
            return False
        self.stats["dag_links"] += 1
        bcast_bad = meta.bcast_name is not None and not self._bcast_ok
        has_carry = meta.carry_name is not None
        try:
            for i, task in enumerate(tasks):
                col = self._cols[k][i]
                if self._skip_member(task, col, n, bcast_bad, has_carry, ok,
                                     fail_reason):
                    continue
                if self._injected.get(col) == k:
                    self._fail(ok, fail_reason, col, task, k,
                               "injected fault", n,
                               where="DAG member failed at node")
                    continue
                if not fan.is_ok(i):
                    self._fail(ok, fail_reason, col, task, k,
                               "non-finite output", n,
                               where="DAG member failed at node")
                    continue
                # explicit True: a node WITHOUT a carry starts a fresh
                # member lineage — an earlier failure in a dead lineage
                # must not leak
                ok[col] = True
                value = fan.member(i)
                overrides[task.name] = value
                self._finish(task, 0, result=value, n_live=n)
                self.stats["fused"] += 1
        except Exception:  # noqa: BLE001 - a shard's wait failed: degrade
            self.stats["degraded"] += 1
            self._degrade(k, ok, fail_reason, overrides)
            return False
        return True

    def _skip_member(self, task: Task, col: int, n: int, bcast_bad: bool,
                     has_carry: bool, ok: np.ndarray,
                     fail_reason: Dict[int, str]) -> bool:
        """Finish a member that cannot run at its node — canceled, fed a
        failed broadcast, or downstream of its own failed carry; True when
        it was finished here."""
        if self.cancel_event.is_set():
            self._finish(task, -2)
            return True
        if bcast_bad:
            ok[col] = False
            fail_reason[col] = (self._bcast_reason
                                or "upstream DAG reduction failed")
            self._finish(task, 1, exception=fail_reason[col], n_live=n,
                         pilot_lost=self._bcast_retryable)
            return True
        if has_carry and not ok[col]:
            self._finish(task, 1, exception=fail_reason.get(
                col, "upstream DAG member failed"), n_live=n,
                pilot_lost=self._fail_retryable.get(col, False))
            return True
        return False

    def _fan_reduce(self, k: int, out: Any,
                    event: Optional["torch.cuda.Event"], ok: np.ndarray,
                    fail_reason: Dict[int, str],
                    overrides: Dict[str, Any]) -> bool:
        task = self.links[k][0]
        try:
            _wait(event)
            value = pytree.tree_map(_reduce_host, out)
        except Exception:  # noqa: BLE001 - degrade this node and the rest
            self.stats["degraded"] += 1
            self._degrade(k, ok, fail_reason, overrides)
            return False
        self.stats["dag_links"] += 1
        if self.cancel_event.is_set():
            self._finish(task, -2)
            return True
        if k in self._injected_reduce:
            self._set_bcast_bad(k, task, "injected fault")
            self._finish(task, 1, exception="injected fault")
            return True
        finite = all(
            np.isfinite(np.asarray(leaf)).all()
            for leaf in pytree.tree_leaves(value)
            if np.issubdtype(np.asarray(leaf).dtype, np.floating))
        if not finite:
            msg = (f"fused reduction produced non-finite values at node "
                   f"{k} (poisoned inputs or no live members)")
            self._set_bcast_bad(k, task, msg)
            self._finish(task, 1, exception=msg)
            return True
        self._bcast_ok = True      # a later reduction refreshes the bcast
        self._bcast_retryable = False
        overrides[task.name] = value
        self._finish(task, 0, result=value)
        self.stats["fused"] += 1
        return True

    def _set_bcast_bad(self, k: int, task: Task, msg: str) -> None:
        self._bcast_ok = False
        self._bcast_reason = (f"upstream DAG reduction failed at node {k}: "
                              f"{msg}")
        self._bcast_retryable = task.retries < task.max_retries

    def _degrade(self, start: int, ok: np.ndarray,
                 fail_reason: Dict[int, str],
                 overrides: Dict[str, Any]) -> None:
        """Sequential per-node fallback for nodes ``start..N-1``, in node
        order inside the carrier: ensemble nodes per-stage fused (then
        per-member scalar inside :func:`execute_fused`), reduction nodes
        SCALAR — resolving member values from the carrier's own overrides
        first, then the store, so a failed member makes the reduce fail
        exactly like the un-fused gather path."""
        for k in range(start, len(self.links)):
            meta = self._meta[k]
            if meta.role == "r":
                self._degrade_reduce(k, overrides)
                continue
            tasks = self.links[k]
            n = len(tasks)
            bcast_bad = meta.bcast_name is not None and not self._bcast_ok
            has_carry = meta.carry_name is not None
            todo: List[Tuple[int, Task]] = []
            for i, task in enumerate(tasks):
                col = self._cols[k][i]
                if self._skip_member(task, col, n, bcast_bad, has_carry, ok,
                                     fail_reason):
                    continue
                if self._injected.get(col) == k:
                    self._fail(ok, fail_reason, col, task, k,
                               "injected fault", n,
                               where="DAG member failed at node")
                    continue
                todo.append((col, task))
            self._run_stage(k, todo, ok, fail_reason, overrides,
                            f"upstream DAG member failed at node {k}")

    def _degrade_reduce(self, k: int, overrides: Dict[str, Any]) -> None:
        task = self.links[k][0]
        if self.cancel_event.is_set():
            self._finish(task, -2)
            return
        if k in self._injected_reduce:
            self._set_bcast_bad(k, task, "injected fault")
            self._finish(task, 1, exception="injected fault")
            return
        try:
            fn, args, kwargs = member_call(task, overrides)
            value = fn(*args, **kwargs)
        except Exception:  # noqa: BLE001 - store-parity: missing member
            self._set_bcast_bad(k, task,
                                f"scalar reduction failed at node {k}")
            self._finish(task, 1,
                         exception=traceback.format_exc(limit=10))
            return
        self._bcast_ok = True
        self._bcast_retryable = False
        overrides[task.name] = value
        self._finish(task, 0, result=value)
        self.stats["scalar_fallback"] += 1
