"""DAG → PST compiler: lower a declarative description onto the core.

The scheduler core (Broker, WorkflowIndex, Emgr, WFProcessor) and the RTS
layer execute Pipelines/Stages/Tasks and know nothing about futures or
combinators. This module closes the gap:

* the **unit graph** — every :class:`~repro.api.futures.TaskSpec` reachable
  from the given nodes, with edges from the futures in args/kwargs plus
  ``after=`` control dependencies — is validated *here*, at compile time:
  cycles, inputs produced by a different workflow, duplicate task names and
  un-loweable shapes all raise :class:`~repro.api.errors.CompileError` with
  messages that name the offending specs;
* weakly-connected components become separate **Pipelines** (independent
  ensembles keep running concurrently, as PST semantics promise);
* each component is **topologically layered** into Stages — one stage per
  dependency level, tasks within a stage ordered widest-``slots``-first so
  the Emgr's largest-fit packer sees its best case without rescanning;
* ``backend=`` affinities become ``Task.backend``, which the federation's
  placement-aware packer turns into ``task.tags['_fed_member']`` pinning;
* adaptive combinators (``repeat_until``/``branch``) become *decision
  tasks* whose stages carry ``post_exec`` hooks — the exact
  append-listener machinery the imperative toolkit always had — that build
  and append the next round/arm at runtime. Anything downstream of an
  adaptive node is compiled eagerly but appended only when the node
  resolves, preserving PST's stage ordering.

Everything the compiler emits is ordinary PST, so the event-driven core,
slot-aware submission, federation failover and journal resume all apply to
declarative workflows unchanged — the layer is compile-time only, with zero
hot-path cost.
"""

from __future__ import annotations

import functools
import itertools
import traceback
from typing import Any, Dict, List, Optional, Sequence, Set, Union

from ..core import uid
from ..core.pst import Pipeline, Stage, Task
from ..core.results import STORE
from ..fusion.groups import (CHAIN_TAG, DAG_TAG, chain_tag, dag_tag,
                             reduction_spec)
from ..fusion.plans import DEFAULT_MIN_CHAIN
from .combinators import (Branch, DecisionContext, Loop, LoopContext)
from .errors import CompileError
from .futures import Future, Node, TaskSpec
from .runtime import COLLECT, TRAMPOLINE, encode, ensure_registered

__all__ = ["compile_workflow", "Compiled"]


# --------------------------------------------------------------------------- #
# Compiled workflow handle
# --------------------------------------------------------------------------- #

class Compiled:
    """The result of :func:`compile_workflow`: PST pipelines + bookkeeping.

    Iterable (``amgr.workflow = compiled`` just works) and inspectable:
    ``compiled.pipelines``, ``compiled.ns`` (the result-store namespace),
    ``compiled.task_names``. ``close()`` drops the namespace's results from
    the process-global store once they are no longer needed.
    """

    def __init__(self, pipelines: List[Pipeline], ns: str, name: str,
                 ctx: "_Ctx") -> None:
        self.pipelines = pipelines
        self.ns = ns
        self.name = name
        self._ctx = ctx

    @property
    def task_names(self) -> List[str]:
        return sorted(self._ctx.used_names)

    @property
    def hook_errors(self) -> List[str]:
        """Adaptive-hook failures (a repeat_until predicate/body or branch
        arm raised at runtime). Non-empty means the workflow 'completed'
        with its adaptivity cut short — check this (api.run() does) when
        driving an AppManager directly."""
        return list(self._ctx.hook_errors)

    def __iter__(self):
        return iter(self.pipelines)

    def __len__(self) -> int:
        return len(self.pipelines)

    def close(self) -> int:
        """Release this workflow's results from the process-global store."""
        return STORE.clear_namespace(self.ns)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<Compiled {self.name!r} ns={self.ns} "
                f"npipelines={len(self.pipelines)}>")


# --------------------------------------------------------------------------- #
# Compiler context (shared with runtime hooks for adaptive rounds)
# --------------------------------------------------------------------------- #

class _Ctx:
    """Per-workflow compile state: namespace, name allocation, name set."""

    def __init__(self, ns: str, wf_name: str, chain: bool = True,
                 min_chain: int = DEFAULT_MIN_CHAIN,
                 shard: bool = True, dag: bool = True) -> None:
        self.ns = ns
        self.wf_name = wf_name
        self.used_names: Set[str] = set()
        self._counters: Dict[str, "itertools.count"] = {}
        self._stage_seq = itertools.count()
        # chain fusion: detection runs per _plan call (static prefix AND
        # runtime-appended adaptive rounds); chain=False / min_chain are the
        # documented opt-outs
        self.chain = chain
        self.min_chain = max(2, int(min_chain))
        # DAG fusion (fan-in reductions + broadcast fan-out) rides on the
        # same superstage machinery; dag=False keeps reductions scalar while
        # linear chains still fuse, chain=False disables both
        self.dag = dag
        # shard=False stamps a _no_shard tag on fused members: the RTS then
        # plans micro-batch lanes only, never an SPMD mesh
        self.shard = shard
        # adaptive-hook failures (predicate/body/arm raised at runtime):
        # post_exec exceptions are recorded-not-fatal in the core, so the
        # API surfaces them through here — api.run() raises on them
        self.hook_errors: List[str] = []

    def claim(self, name: str, what: str) -> str:
        if name in self.used_names:
            raise CompileError(
                f"duplicate task name {name!r} in workflow "
                f"{self.wf_name!r} ({what}) — task names key resume and "
                f"result routing; make them unique (adaptive rounds: "
                f"include the round index)")
        self.used_names.add(name)
        return name

    def fresh(self, key: str) -> str:
        """Deterministic per-workflow sequence names: <key>-0, <key>-1, ..."""
        counter = self._counters.setdefault(key, itertools.count())
        return f"{key}-{next(counter)}"

    def auto_name(self, spec: TaskSpec, prefix: str) -> str:
        """Deterministic name for an unnamed spec: <prefix><fn>-<k>."""
        if isinstance(spec.fn, str):
            base = "task"
        else:
            base = getattr(spec.fn, "__name__", "task").strip("<>") or "task"
        return self.fresh(prefix + base)

    def stage_name(self) -> str:
        return f"{self.wf_name}-s{next(self._stage_seq)}"


# --------------------------------------------------------------------------- #
# Unit-graph construction
# --------------------------------------------------------------------------- #

def _collect_units(nodes: Sequence[Union[Node, Future]], ns: str
                   ) -> List[TaskSpec]:
    """Transitive closure of specs reachable from ``nodes``.

    Specs already compiled into *this* workflow (``spec.ns == ns``) are
    external, satisfied inputs; specs compiled into a different workflow are
    an error — their values live under another namespace and would never
    resolve here.
    """
    frontier: List[TaskSpec] = []
    for node in nodes:
        if isinstance(node, Future):
            frontier.append(node.owner)
        elif isinstance(node, Node):
            frontier.extend(f.owner for f in node.futures())
        else:
            raise CompileError(
                f"compile() takes nodes or futures, got "
                f"{type(node).__name__}: {node!r}")
    units: List[TaskSpec] = []
    seen: Set[int] = set()
    while frontier:
        spec = frontier.pop()
        if id(spec) in seen:
            continue
        seen.add(id(spec))
        if spec.ns is not None:
            if spec.ns != ns:
                raise CompileError(
                    f"input {spec.name!r} was produced by a different "
                    f"compile() call (namespace {spec.ns}) — a workflow can "
                    f"only consume futures of its own specs")
            continue  # already lowered earlier in this workflow
        units.append(spec)
        for f in spec.inputs():
            frontier.append(f.owner)
    # deterministic order for naming/layering tie-breaks
    units.reverse()
    return units


def _dependencies(spec: TaskSpec, member: Set[int],
                  alias: Dict[int, TaskSpec]) -> List[TaskSpec]:
    deps = []
    for f in spec.inputs():
        owner = alias.get(id(f.owner), f.owner)
        if id(owner) in member:
            deps.append(owner)
    return deps


def _find_cycle(units: List[TaskSpec], member: Set[int],
                alias: Dict[int, TaskSpec]) -> List[str]:
    """Best-effort cycle extraction for the error message."""
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[int, int] = {id(u): WHITE for u in units}
    path: List[TaskSpec] = []

    def label(s: TaskSpec) -> str:
        return s.name or s.explicit_name or repr(s)

    def dfs(u: TaskSpec) -> Optional[List[str]]:
        color[id(u)] = GREY
        path.append(u)
        for d in _dependencies(u, member, alias):
            c = color.get(id(d), BLACK)
            if c == GREY:
                start = next(i for i, s in enumerate(path) if s is d)
                return [label(s) for s in path[start:]] + [label(d)]
            if c == WHITE:
                found = dfs(d)
                if found:
                    return found
        path.pop()
        color[id(u)] = BLACK
        return None

    for u in units:
        if color[id(u)] == WHITE:
            found = dfs(u)
            if found:
                return found
    return [label(u) for u in units[:5]]


# --------------------------------------------------------------------------- #
# Task building
# --------------------------------------------------------------------------- #

def _has_future(value: Any) -> bool:
    if isinstance(value, Future):
        return True
    if isinstance(value, (list, tuple)):
        return any(_has_future(v) for v in value)
    if isinstance(value, dict):
        return any(_has_future(v) for v in value.values())
    return False


def _build_task(spec: TaskSpec, ctx: _Ctx) -> Task:
    """Lower one spec to a core Task (trampoline-wrapped when it is data-flow)."""
    if isinstance(spec.fn, str) and spec.fn == "__collect__":
        fn_ref: Optional[str] = COLLECT
    elif isinstance(spec.fn, str) and spec.fn.startswith("reg://"):
        fn_ref = spec.fn
    elif isinstance(spec.fn, str):
        # synthetic executable (sleep://...): no callable to hand values to
        if _has_future(spec.args) or _has_future(spec.kwargs):
            raise CompileError(
                f"task {spec.name!r} uses executable {spec.fn!r} but "
                f"consumes futures — only Python callables (or reg:// "
                f"registrations) can receive data-flow inputs")
        fn_ref = None
    else:
        fn_ref = ensure_registered(spec.fn)
    if fn_ref is None:
        task = Task(
            name=spec.name, executable=spec.fn, args=spec.args,
            kwargs=spec.kwargs, slots=spec.slots, backend=spec.backend,
            max_retries=spec.max_retries, duration_hint=spec.duration_hint)
    else:
        where = f"task {spec.name!r}"
        task = Task(
            name=spec.name, executable=TRAMPOLINE,
            kwargs={"__ns__": ctx.ns, "__fn__": fn_ref,
                    "__args__": encode(spec.args, where),
                    "__kwargs__": encode(spec.kwargs, where)},
            slots=spec.slots, backend=spec.backend,
            max_retries=spec.max_retries, duration_hint=spec.duration_hint)
    task.tags["_wf_ns"] = ctx.ns
    task.ns = ctx.ns
    if spec.fusion_group is not None:
        # the Emgr packer and a fusion-capable RTS read this tag to batch
        # congruent ensemble members into one device dispatch
        task.tags["_fusion_group"] = spec.fusion_group
        if not ctx.shard:
            task.tags["_no_shard"] = True
    if spec._chain_tag is not None:
        # chain detection placed this member on a fused chain: the WFP
        # superstage scheduler and a chain-capable RTS read this tag to
        # hand off / compose whole chains instead of one stage at a time
        task.tags[CHAIN_TAG] = dict(spec._chain_tag)
    if spec._dag_tag is not None:
        # DAG detection placed this task on a fused fan-in/fan-out DAG:
        # same hand-off machinery, with the reduction executed device-side
        # inside the carrier
        task.tags[DAG_TAG] = dict(spec._dag_tag)
    spec.task = task
    spec.ns = ctx.ns
    return task


# --------------------------------------------------------------------------- #
# Chain detection (perf: cross-stage chain fusion)
# --------------------------------------------------------------------------- #

def _chain_carry(spec: TaskSpec) -> Optional["tuple[str, TaskSpec]"]:
    """If ``spec``'s data flow is exactly ONE whole-kwarg future, return
    ``(kwarg name, producing spec)``; else None.

    This is the elementwise-link shape: the member consumes a single
    upstream member's output and nothing else (no ``after=`` control edges,
    no futures in args, none nested inside containers)."""
    if spec.after or _has_future(spec.args):
        return None
    carry = None
    for k, v in spec.kwargs.items():
        if isinstance(v, Future):
            if carry is not None or v.key is not None:
                return None  # two futures, or an aggregate (loop/branch) future
            carry = (k, v.owner)
        elif _has_future(v):
            return None  # nested future: not a whole-kwarg carry
    return carry


def _elementwise_pred(ens) -> Optional["tuple[Any, str]"]:
    """The ensemble that ``ens`` consumes elementwise, plus the carry kwarg
    name — or None when ``ens`` is not a chain link.

    Member *i* must consume exactly member *i*'s future of one upstream
    ensemble (index-aligned, no permutation), under one common kwarg name,
    with matching slots/backend per member ("same group key modulo
    kernel": one member-width lease can then run both links)."""
    carries = [_chain_carry(s) for s in ens.specs]
    if any(c is None for c in carries):
        return None
    names = {c[0] for c in carries}
    if len(names) != 1:
        return None
    owners = [c[1] for c in carries]
    pred = getattr(owners[0], "_ens", None)
    if pred is None or pred is ens or len(pred.specs) != len(ens.specs):
        return None
    for s, o, po in zip(ens.specs, owners, pred.specs):
        if o is not po:           # member-i must consume member-i
            return None
        if s.slots != o.slots or s.backend != o.backend:
            return None
        if o.fusion_group is None:
            return None
    return pred, names.pop()


# --------------------------------------------------------------------------- #
# DAG detection (perf: fan-in/fan-out fusion — reductions inside the carrier)
# --------------------------------------------------------------------------- #

def _whole_ensembles(units: List[TaskSpec]) -> List[Any]:
    """Fusable ensembles FULLY contained in this unit set, in unit order,
    none of whose members are already claimed by a chain or a DAG."""
    member = {id(u) for u in units}
    present: Dict[int, int] = {}
    ensembles: List[Any] = []
    for u in units:
        ens = u._ens
        if (ens is None or u.fusion_group is None or u.dynamic is not None
                or u._chain_tag is not None or u._dag_tag is not None):
            continue
        if id(ens) not in present:
            present[id(ens)] = 0
            ensembles.append(ens)
        present[id(ens)] += 1
    return [e for e in ensembles
            if present[id(e)] == len(e.specs)
            and all(id(s) in member for s in e.specs)]


def _reduce_edge(spec: TaskSpec, whole_ids: Set[int]
                 ) -> Optional["tuple[Any, Any]"]:
    """If ``spec`` is a fusable reduction consuming exactly one whole
    ensemble, return ``(ensemble, ReductionSpec)``; else None.

    The fan-in anchor is the ``api.gather`` shape: a single positional
    argument that is the full, index-aligned list of one ensemble's member
    futures — nothing else flows in (no kwargs futures, no ``after=``),
    and the reducer is ``@fusable_reduction``-marked (commutative). The
    reducer must share the ensemble's slots/backend so one lease shape
    (and one Emgr width bucket) covers the whole DAG.
    """
    if (spec._ens is not None or spec.dynamic is not None
            or spec._chain_tag is not None or spec._dag_tag is not None
            or isinstance(spec.fn, str)):
        return None
    rspec = reduction_spec(spec.fn)
    if rspec is None or spec.after or _has_future(spec.kwargs):
        return None
    if len(spec.args) != 1 or not isinstance(spec.args[0], (list, tuple)):
        return None
    futs = list(spec.args[0])
    if not futs or not all(isinstance(f, Future) and f.key is None
                           for f in futs):
        return None
    ens = getattr(futs[0].owner, "_ens", None)
    if ens is None or id(ens) not in whole_ids:
        return None
    if len(futs) != len(ens.specs) or any(
            f.owner is not s for f, s in zip(futs, ens.specs)):
        return None
    first = ens.specs[0]
    if spec.slots != first.slots or spec.backend != first.backend:
        return None
    return ens, rspec


def _dag_fanout_edge(ens, red_by_id: Dict[int, "tuple[Any, Any, Any]"]
                     ) -> Optional["tuple[Any, Optional[str], Any, str]"]:
    """If every member of ``ens`` consumes one reducer's output under one
    common kwarg, return ``(reducer spec, carry kwarg | None,
    carry pred ensemble | None, broadcast kwarg)``; else None.

    This is the fan-out shape: the reduction's scalar/array value enters
    every member as a *shared* (broadcast) argument. Members may
    additionally carry elementwise from an upstream ensemble (the diamond
    ``A → reduce → B`` with ``A → B`` member-aligned), under one common
    kwarg with index-aligned owners — exactly the chain-carry discipline.
    """
    rows = []
    for s in ens.specs:
        if s.after or _has_future(s.args):
            return None
        c = b = None
        for k, v in s.kwargs.items():
            if isinstance(v, Future):
                if v.key is not None:
                    return None
                if id(v.owner) in red_by_id:
                    if b is not None:
                        return None
                    b = (k, v.owner)
                else:
                    if c is not None:
                        return None
                    c = (k, v.owner)
            elif _has_future(v):
                return None
        if b is None:
            return None
        rows.append((c, b))
    reducer, bname = rows[0][1][1], rows[0][1][0]
    if any(b[1] is not reducer or b[0] != bname for _, b in rows):
        return None
    carries = [c for c, _ in rows]
    carry_name = carry_pred = None
    if any(c is not None for c in carries):
        if any(c is None for c in carries):
            return None
        names = {c[0] for c in carries}
        if len(names) != 1:
            return None
        carry_name = names.pop()
        owners = [c[1] for c in carries]
        carry_pred = getattr(owners[0], "_ens", None)
        if (carry_pred is None or carry_pred is ens
                or len(carry_pred.specs) != len(ens.specs)
                or any(o is not p for o, p in zip(owners,
                                                  carry_pred.specs))):
            return None
    if any(s.slots != reducer.slots or s.backend != reducer.backend
           for s in ens.specs):
        return None
    return reducer, carry_name, carry_pred, bname


def _detect_dags(units: List[TaskSpec], ctx: _Ctx) -> None:
    """Tag linear node sequences with fan-in/fan-out reductions as DAGs.

    A fused DAG is a path of NODES — fusable ensembles (role "e") and
    marked reductions (role "r") — where consecutive nodes are connected
    by elementwise carries, whole-ensemble fan-in, or broadcast fan-out.
    At least one reduction must be on the path (pure elementwise runs stay
    chains, see :func:`_detect_chains`, which runs after this and skips
    DAG-claimed specs). Runs per ``_plan`` call, so adaptive rounds get
    their round DAG (``ensemble → gather → broadcast → ensemble``) tagged
    exactly like the static prefix. Tagging is advisory, same contract as
    chains: a DAG-incapable RTS executes the stages per-stage-fused.
    """
    if not (ctx.dag and ctx.chain):
        return
    whole = _whole_ensembles(units)
    if not whole:
        return
    whole_ids = {id(e) for e in whole}

    # fan-in edges; an ensemble reduced by two gathers is a genuine
    # fan-out of its member values — ambiguous, drop both reducers
    red_by_id: Dict[int, "tuple[Any, Any, Any]"] = {}  # id(spec)->(spec,ens,rspec)
    fan_in_of: Dict[int, TaskSpec] = {}
    conflicted: Set[int] = set()
    for u in units:
        got = _reduce_edge(u, whole_ids)
        if got is None:
            continue
        ens, rspec = got
        if id(ens) in fan_in_of:
            conflicted.add(id(ens))
            continue
        fan_in_of[id(ens)] = u
        red_by_id[id(u)] = (u, ens, rspec)
    for eid in conflicted:
        r = fan_in_of.pop(eid, None)
        if r is not None:
            red_by_id.pop(id(r), None)
    if not red_by_id:
        return

    # linearize: one successor per node, chain-style fan-out discipline
    succ: Dict[int, Any] = {}
    pred_edge: Dict[int, Dict[str, Any]] = {}
    fanout: Set[int] = set()

    def add_edge(src, dst, a=None, b=None):
        if id(src) in succ:
            fanout.add(id(src))
            return
        succ[id(src)] = dst
        pred_edge[id(dst)] = {"pred": src, "a": a, "b": b}

    for u, ens, _rspec in red_by_id.values():
        add_edge(ens, u)
    for ens in whole:
        out_edge = _dag_fanout_edge(ens, red_by_id)
        if out_edge is not None:
            reducer, carry_name, carry_pred, bname = out_edge
            # a diamond's elementwise carry must come from the ensemble
            # the reduction consumed (the node right before it on the
            # path) — anything else is not a linear node sequence
            src_ens = red_by_id[id(reducer)][1]
            if carry_name is not None and carry_pred is not src_ens:
                continue
            add_edge(reducer, ens, a=carry_name, b=bname)
            continue
        in_edge = _elementwise_pred(ens)
        if in_edge is not None and id(in_edge[0]) in whole_ids:
            add_edge(in_edge[0], ens, a=in_edge[1])
    for src in fanout:
        dst = succ.pop(src, None)
        if dst is not None:
            pred_edge.pop(id(dst), None)

    # maximal paths from ensemble heads; tag only reduction-bearing ones
    for head in whole:
        if id(head) in pred_edge or id(head) not in succ:
            continue
        path: List[Any] = [head]
        cur = head
        while id(cur) in succ:
            cur = succ[id(cur)]
            path.append(cur)
        if not any(id(n) in red_by_id for n in path):
            continue
        did = ctx.fresh(f"{ctx.wf_name}-dag")
        n = len(path)
        for k, node in enumerate(path):
            if id(node) in red_by_id:
                _, _, rspec = red_by_id[id(node)]
                node._dag_tag = dag_tag(
                    did, k, 0, n, width=1, role="r",
                    kind=None if rspec.combine is not None else rspec.kind)
            else:
                edge = pred_edge.get(id(node)) or {}
                w = len(node.specs)
                for m, spec in enumerate(node.specs):
                    spec._dag_tag = dag_tag(
                        did, k, m, n, width=w, role="e",
                        carry=edge.get("a"), broadcast=edge.get("b"))


def _detect_chains(units: List[TaskSpec], ctx: _Ctx) -> None:
    """Tag linear chains of fusable elementwise ensemble stages.

    Runs per ``_plan`` call, so runtime-appended adaptive rounds get their
    chains detected exactly like the static prefix. Tagging is advisory:
    an RTS without chain support executes the stages per-stage-fused (the
    WFProcessor only superstages when the RTS composes chains), and
    ``ctx.chain=False`` / ``ctx.min_chain`` opt out entirely.
    """
    if not ctx.chain:
        return
    # fusable ensembles fully contained in this unit set, in unit order
    # (DAG detection ran first and claimed its nodes — skipped here)
    whole = _whole_ensembles(units)
    if len(whole) < 2:
        return
    whole_ids = {id(e) for e in whole}
    # elementwise edges pred -> ens; a pred consumed elementwise by TWO
    # ensembles is a fan-out point, not a chain interior — drop its edges
    succ: Dict[int, Any] = {}
    pred_of: Dict[int, "tuple[Any, str]"] = {}
    fanout: Set[int] = set()
    for ens in whole:
        edge = _elementwise_pred(ens)
        if edge is None or id(edge[0]) not in whole_ids:
            continue
        pid = id(edge[0])
        if pid in succ:
            fanout.add(pid)
            continue
        succ[pid] = ens
        pred_of[id(ens)] = edge
    for pid in fanout:
        follower = succ.pop(pid, None)
        if follower is not None:
            pred_of.pop(id(follower), None)
    # maximal paths: start at links with no predecessor edge, follow succ
    for ens in whole:
        if id(ens) in pred_of or id(ens) not in succ:
            continue
        path, carries = [ens], [None]
        cur = ens
        while id(cur) in succ:
            nxt = succ[id(cur)]
            path.append(nxt)
            carries.append(pred_of[id(nxt)][1])
            cur = nxt
        if len(path) < ctx.min_chain:
            continue
        cid = ctx.fresh(f"{ctx.wf_name}-chain")
        for k, link in enumerate(path):
            for m, spec in enumerate(link.specs):
                spec._chain_tag = chain_tag(cid, k, m, len(path),
                                            carry=carries[k])


# --------------------------------------------------------------------------- #
# Planning: units -> [Stage, ..., decision Stage?]
# --------------------------------------------------------------------------- #

def _plan(units: List[TaskSpec], ctx: _Ctx, prefix: str,
          alias: Optional[Dict[int, TaskSpec]] = None) -> List[Stage]:
    """Plan a unit set into an ordered stage list.

    Static units are layered topologically (one Stage per level, widest
    tasks first). At most one *ready* adaptive unit may exist at any point;
    it becomes the trailing decision stage and everything after it is
    planned recursively into its runtime continuation. Two adaptive units
    neither of which depends on the other cannot share a pipeline (their
    runtime appends would interleave into one stage sequence) — that is a
    compile error, not a runtime surprise.
    """
    alias = dict(alias or {})
    if not units:
        return []
    member = {id(u) for u in units}

    # fusion detection before tasks are built (adaptive rounds re-enter
    # here at runtime, so their round DAGs/chains are detected too): DAGs
    # first — they claim reduction-bearing paths — then linear chains over
    # whatever is left
    _detect_dags(units, ctx)
    _detect_chains(units, ctx)

    # names first: every error message and placeholder needs them
    # (continuation units re-enter _plan recursively — claim exactly once)
    for spec in units:
        if spec._claimed:
            continue
        dyn = spec.dynamic
        if isinstance(dyn, (Loop, Branch)) and dyn.name is None:
            # default combinator names come from the per-workflow counters
            # (a process-global counter would drift across sessions and
            # silently break journal-resume name matching)
            kind = "repeat-until" if isinstance(dyn, Loop) else "branch"
            dyn.name = ctx.fresh(prefix + kind)
            dyn.out.key = dyn.name
            suffix = "-entry" if isinstance(dyn, Loop) else "-decide"
            spec.name = spec.name or f"{dyn.name}{suffix}"
        if isinstance(dyn, Loop):
            continue  # loop placeholders never become tasks
        if spec.name is None:
            spec.name = ctx.auto_name(spec, prefix)
        ctx.claim(spec.name, "explicitly named" if spec.explicit_name
                  else "auto-named")
        spec._claimed = True

    # Kahn layering over intra-set dependencies
    level: Dict[int, int] = {}
    remaining = list(units)
    current = 0
    while remaining:
        ready = [u for u in remaining
                 if all(id(d) in level for d in
                        _dependencies(u, member, alias))]
        if not ready:
            cycle = _find_cycle(remaining, member, alias)
            raise CompileError(
                f"dependency cycle in workflow {ctx.wf_name!r}: "
                f"{' -> '.join(cycle) or [s.name for s in remaining[:5]]} — "
                f"a task cannot (transitively) consume its own output")
        for u in ready:
            deps = _dependencies(u, member, alias)
            level[id(u)] = (max(level[id(d)] for d in deps) + 1) if deps \
                else current
        # exact levels come from the max-over-deps above; 'current' only
        # seeds roots discovered in later waves at their true depth
        remaining = [u for u in remaining if id(u) not in level]
        current += 1

    dynamics = [u for u in units if u.dynamic is not None]
    if not dynamics:
        return _layer_stages(units, level, ctx)

    # split: static prefix = units with no transitive dynamic dependency
    dyn_ids = {id(d) for d in dynamics}
    tainted: Set[int] = set(dyn_ids)
    changed = True
    while changed:
        changed = False
        for u in units:
            if id(u) in tainted:
                continue
            if any(id(d) in tainted
                   for d in _dependencies(u, member, alias)):
                tainted.add(id(u))
                changed = True
    pre = [u for u in units if id(u) not in tainted]
    ready_dyn = [d for d in dynamics
                 if not any(id(x) in tainted
                            for x in _dependencies(d, member, alias))]
    if len(ready_dyn) > 1:
        names = [d.dynamic.name for d in ready_dyn]
        raise CompileError(
            f"parallel adaptive combinators {names} in one connected "
            f"workflow — their runtime appends would interleave in a single "
            f"PST stage sequence. Sequence them (chain/after=) or keep them "
            f"in disconnected sub-workflows (separate pipelines)")
    d = ready_dyn[0]
    rest = [u for u in units if id(u) in tainted and u is not d]
    stages = _layer_stages(pre, level, ctx)
    stages.extend(_plan_dynamic(d, rest, ctx, prefix, alias))
    return stages


def _layer_stages(units: List[TaskSpec], level: Dict[int, int],
                  ctx: _Ctx) -> List[Stage]:
    by_level: Dict[int, List[TaskSpec]] = {}
    for u in units:
        by_level.setdefault(level[id(u)], []).append(u)
    stages = []
    for lv in sorted(by_level):
        specs = by_level[lv]
        # widest-first within the layer: the slot-aware packer backfills
        # from its largest width bucket, so presenting wide tasks first
        # keeps the pilot packed without starving narrow ones
        specs.sort(key=lambda s: -s.slots)
        stage = Stage(ctx.stage_name())
        stage.ns = ctx.ns
        for spec in specs:
            stage.add_tasks(_build_task(spec, ctx))
        stages.append(stage)
    return stages


def _plan_dynamic(d: TaskSpec, rest: List[TaskSpec], ctx: _Ctx,
                  prefix: str, alias: Dict[int, TaskSpec]) -> List[Stage]:
    dyn = d.dynamic
    if isinstance(dyn, Loop):
        # expand the loop placeholder into round 0 + its check spec; the
        # check carries the runtime hook; everything in ``rest`` becomes the
        # loop's continuation (planned inside the recursive _plan call)
        ctx.claim(dyn.name, "repeat_until name (reserves its result key)")
        rt = _LoopRuntime(dyn, ctx)
        d.ns = ctx.ns  # bind the placeholder: loop futures resolve here
        round_units, check = rt.round_units(0, LoopContext(0, None, []))
        # rounds inherit the loop's own entry dependencies
        for u in round_units:
            u.after = list(u.after) + list(d.after)
        alias = dict(alias)
        alias[id(d)] = check  # rest's edges on the loop now point at round 0
        return _plan(round_units + rest, ctx, prefix, alias)
    if isinstance(dyn, Branch):
        ctx.claim(dyn.name, "branch name (reserves its join/result key)")
        rt = _BranchRuntime(dyn, ctx)
        stage = Stage(ctx.stage_name())
        stage.ns = ctx.ns
        stage.add_tasks(_build_task(d, ctx))
        rt.continuation = _plan(rest, ctx, prefix, alias)
        stage.post_exec = rt.on_decide
        return [stage]
    if isinstance(dyn, _LoopRuntime):
        stage = Stage(ctx.stage_name())
        stage.ns = ctx.ns
        stage.add_tasks(_build_task(d, ctx))
        if rest:
            # compile-time only: runtime rounds never carry a continuation,
            # and must not wipe the one captured at compile time
            dyn.continuation = _plan(rest, ctx, prefix, alias)
        stage.post_exec = dyn.on_check_done
        return [stage]
    if isinstance(dyn, _JoinRuntime):
        stage = Stage(ctx.stage_name())
        stage.ns = ctx.ns
        stage.add_tasks(_build_task(d, ctx))
        if rest:
            raise CompileError("internal: join cannot carry a continuation")
        stage.post_exec = dyn.on_join_done
        return [stage]
    raise CompileError(f"unknown adaptive combinator {type(dyn).__name__}")


# --------------------------------------------------------------------------- #
# Runtime hooks (post_exec side of the adaptive combinators)
# --------------------------------------------------------------------------- #

def _surfacing(hook):
    """Record a hook failure in the workflow's compile context before the
    core's post_exec guard swallows it: a raising predicate/body/arm would
    otherwise silently truncate the loop while the run reports all_done.
    ``api.run()`` raises on ``ctx.hook_errors``; direct AppManager drivers
    can read ``Compiled.hook_errors``."""
    @functools.wraps(hook)
    def wrapped(self, stage, pipe):
        try:
            hook(self, stage, pipe)
        except Exception:  # noqa: BLE001 - recorded, then re-raised for the core log
            self.ctx.hook_errors.append(
                f"{type(self).__name__}[{stage.name}]: "
                f"{traceback.format_exc(limit=5)}")
            raise
    return wrapped


class _LoopRuntime:
    """Per-loop runtime state shared by every round's check stage.

    Rounds fire strictly in order (each check stage is appended by the
    previous one), so plain attributes suffice. On journal resume the hooks
    re-fire for instantly-closing resumed stages in the same order, with the
    check tasks' results restored from the journal — the loop replays its
    own history deterministically instead of persisting hook state.
    """

    def __init__(self, loop: Loop, ctx: _Ctx) -> None:
        self.loop = loop
        self.ctx = ctx
        self.history: List[List[Any]] = []
        self.continuation: List[Stage] = []

    def round_units(self, k: int, lctx: LoopContext
                    ) -> "tuple[List[TaskSpec], TaskSpec]":
        node = self.loop.body(lctx)
        if not isinstance(node, Node):
            raise CompileError(
                f"repeat_until body for {self.loop.name!r} round {k} must "
                f"return a node, got {type(node).__name__}")
        check = TaskSpec("__collect__", args=(list(node.futures()),),
                         name=f"{self.loop.name}-r{k}-check")
        check.dynamic = self
        units = _collect_units([check], self.ctx.ns)
        return units, check

    @_surfacing
    def on_check_done(self, stage: Stage, pipe: Pipeline) -> None:
        results = stage.tasks[0].result
        k = len(self.history)
        self.history.append(results)
        lctx = LoopContext(k, results, self.history)
        stop = bool(self.loop.predicate(lctx)) or (k + 1
                                                   >= self.loop.max_rounds)
        if stop:
            STORE.put(self.ctx.ns, self.loop.name, results)
            if self.continuation:
                pipe.add_stages(self.continuation)
            return
        next_ctx = LoopContext(k + 1, results, self.history)
        units, _check = self.round_units(k + 1, next_ctx)
        stages = _plan(units, self.ctx, f"{self.loop.name}-r{k + 1}-")
        pipe.add_stages(stages)


class _BranchRuntime:
    """Decision-stage hook: build and append the chosen arm at runtime."""

    def __init__(self, br: Branch, ctx: _Ctx) -> None:
        self.branch = br
        self.ctx = ctx
        self.continuation: List[Stage] = []

    @_surfacing
    def on_decide(self, stage: Stage, pipe: Pipeline) -> None:
        results = stage.tasks[0].result
        dctx = DecisionContext(results)
        arm = self.branch.then if self.branch.cond(dctx) else \
            self.branch.orelse
        if arm is not None and not isinstance(arm, Node) and callable(arm):
            arm = arm(dctx)
        if arm is None:
            # nothing to run: the branch resolves to its decision inputs
            STORE.put(self.ctx.ns, self.branch.name, results)
            if self.continuation:
                pipe.add_stages(self.continuation)
            return
        if not isinstance(arm, Node):
            raise CompileError(
                f"branch {self.branch.name!r} arm must be a node / builder "
                f"returning one, got {type(arm).__name__}")
        join = TaskSpec("__collect__", args=(list(arm.futures()),),
                        name=self.branch.name)
        join._claimed = True   # the branch name was reserved at compile time
        join.dynamic = _JoinRuntime(self)
        units = _collect_units([join], self.ctx.ns)
        stages = _plan(units, self.ctx, f"{self.branch.name}-")
        pipe.add_stages(stages)


class _JoinRuntime:
    """The chosen arm's join stage: resolves the branch future, then
    releases the branch's continuation. The join task is named after the
    branch itself, so its (journaled, resumable) result *is* the branch's
    value — no extra store bookkeeping to persist."""

    def __init__(self, branch_rt: _BranchRuntime) -> None:
        self.branch_rt = branch_rt
        self.ctx = branch_rt.ctx

    @_surfacing
    def on_join_done(self, stage: Stage, pipe: Pipeline) -> None:
        if self.branch_rt.continuation:
            pipe.add_stages(self.branch_rt.continuation)


# --------------------------------------------------------------------------- #
# Entry point
# --------------------------------------------------------------------------- #

def compile_workflow(*nodes: Union[Node, Future],
                     name: Optional[str] = None,
                     chain: bool = True,
                     min_chain: int = DEFAULT_MIN_CHAIN,
                     shard: bool = True,
                     dag: bool = True) -> Compiled:
    """Compile a declarative description into PST pipelines.

    Weakly-connected components of the task DAG become separate (and
    therefore concurrent) pipelines; within a component, dependency levels
    become sequential stages. All description errors surface here.

    ``chain``/``min_chain``: linear runs of >= ``min_chain`` fusable
    ensemble stages with elementwise data flow are tagged as fusion
    *chains*, which a chain-capable RTS executes as composed device
    dispatches with the intermediate member values never touching the
    host. ``chain=False`` opts the workflow out (stages still fuse
    per-stage); raising ``min_chain`` opts out short chains only.

    ``shard=False`` opts the workflow out of SPMD mesh sharding: fused
    groups then execute as per-device micro-batch lanes even on a
    multi-device runtime (``JaxRTS(shard_min_members=n)`` is the
    runtime-side knob for tuning rather than disabling).

    ``dag``: node paths carrying a ``@fusable_reduction`` fan-in (and an
    optional broadcast fan-out into the next ensemble) are tagged as
    fusion *DAGs*, which a DAG-capable RTS executes as ONE composed
    dispatch — the reduction runs device-side inside the carrier.
    ``dag=False`` keeps reductions scalar (chains still fuse);
    ``chain=False`` disables both cross-stage tiers.
    """
    if not nodes:
        raise CompileError("compile() needs at least one node")
    ns = uid.generate("wf")
    wf_name = name or ns
    ctx = _Ctx(ns, wf_name, chain=chain, min_chain=min_chain, shard=shard,
               dag=dag)
    units = _collect_units(list(nodes), ns)
    if not units:
        raise CompileError("compile() found no tasks to run — every input "
                           "was already compiled elsewhere")
    # DAG + chain detection over the FULL unit graph, before the component
    # split below partitions independent member chains into separate
    # pipelines (each member's a->b->c run is its own weakly-connected
    # component when nothing downstream joins them)
    _detect_dags(units, ctx)
    _detect_chains(units, ctx)

    # weakly-connected components -> independent pipelines
    parent: Dict[int, int] = {id(u): id(u) for u in units}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    member = {id(u) for u in units}
    for u in units:
        for dep in _dependencies(u, member, {}):
            union(id(u), id(dep))
    components: Dict[int, List[TaskSpec]] = {}
    for u in units:
        components.setdefault(find(id(u)), []).append(u)

    pipelines = []
    order = {id(u): i for i, u in enumerate(units)}
    comps = sorted(components.values(), key=lambda c: order[id(c[0])])
    for ci, comp in enumerate(comps):
        suffix = f"-c{ci}" if len(comps) > 1 else ""
        pipe = Pipeline(f"{wf_name}{suffix}")
        pipe.ns = ns
        stages = _plan(comp, ctx, "")
        if not stages:
            raise CompileError(
                f"component {ci} of workflow {wf_name!r} compiled to zero "
                f"stages")
        pipe.add_stages(stages)
        pipelines.append(pipe)
    # stamp each fused member with its group's total width: the RTS packer
    # reads the hint to hold a partially-arrived wide group for a full-mesh
    # dispatch instead of fragmenting it across the submission stream
    widths: Dict[str, int] = {}
    for pipe in pipelines:
        for stage in pipe.stages:
            for task in stage.tasks:
                key = task.tags.get("_fusion_group")
                if key is not None:
                    widths[key] = widths.get(key, 0) + 1
    for pipe in pipelines:
        for stage in pipe.stages:
            for task in stage.tasks:
                key = task.tags.get("_fusion_group")
                if key is not None:
                    task.tags["_fusion_width"] = widths[key]
    return Compiled(pipelines, ns, wf_name, ctx)
