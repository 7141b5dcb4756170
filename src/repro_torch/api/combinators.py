"""Ensemble combinators: the declarative vocabulary over TaskSpec/Future.

* :func:`sweep` — a cartesian parameter space (``sweep(x=[1,2], y=[3,4])``).
* :func:`ensemble` — one task per parameter point (``ensemble(fn, over=...)``).
* :func:`chain` — sequential composition, with optional data-flow threading
  when the links are bare callables.
* :func:`gather` — a reduction task consuming a whole ensemble's outputs.
* :func:`branch` — a runtime decision appending one of two sub-workflows
  (the paper's branching-as-decision-task).
* :func:`repeat_until` — an adaptive loop whose rounds are appended at
  runtime through the PST ``post_exec``/append-listener machinery, with
  results flowing between rounds.

All of these only *describe*; :func:`repro.api.compile` lowers them onto
Pipelines/Stages/Tasks.
"""

from __future__ import annotations

import itertools
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Union)

from .errors import CompileError
from .futures import Future, Node, TaskSpec, _as_future_list

BodyBuilder = Callable[["LoopContext"], Node]
BranchArm = Union[None, Node, Callable[["DecisionContext"], Optional[Node]]]


def sweep(**params: Iterable[Any]) -> List[Dict[str, Any]]:
    """Cartesian product of named parameter ranges, as kwargs dicts.

    ``sweep(x=range(2), y=("a", "b"))`` →
    ``[{'x': 0, 'y': 'a'}, {'x': 0, 'y': 'b'}, {'x': 1, 'y': 'a'}, ...]``.
    The order is deterministic (itertools.product over the given order),
    which keeps generated task names — and therefore resume — stable.
    """
    if not params:
        return [{}]
    names = list(params)
    values = [list(v) for v in params.values()]
    return [dict(zip(names, combo)) for combo in itertools.product(*values)]


class Ensemble(Node):
    """A set of independent tasks over a parameter space (one PST stage)."""

    def __init__(self, specs: List[TaskSpec], name: Optional[str]) -> None:
        self.specs = specs
        self.name = name
        for s in specs:
            # chain detection needs the ensemble identity: two stages of the
            # same kernel share a fusion-group key, so the key alone cannot
            # tell "stage k's members" from "stage k+1's members"
            s._ens = self

    def futures(self) -> List[Future]:
        return [s.out for s in self.specs]

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def then(
        self,
        fn: Callable[..., Any],
        over: Optional[Sequence[Dict[str, Any]]] = None,
        *,
        name: Optional[str] = None,
        arg: Optional[str] = None,
        slots: Optional[int] = None,
        max_retries: int = 0,
        duration_hint: Optional[float] = None,
        fuse: bool = True,
    ) -> "Ensemble":
        """Elementwise continuation: member *i* of the new stage consumes
        member *i*'s output of this stage (and nothing else).

        ``arg`` names the parameter the carried value arrives under
        (default: ``fn``'s first parameter); ``over`` optionally supplies
        one extra kwargs dict per member (same length as this ensemble).
        Consecutive fusable stages built this way form an elementwise
        *chain*: the compiler detects it and a chain-capable RTS executes
        each micro-batch of members through ALL the stages as one composed
        device dispatch, with the intermediate values never touching the
        host. ``fuse=False`` on any stage (or ``chain=False`` /
        ``min_chain`` at :func:`repro.api.compile`) opts out.
        """
        if arg is None:
            import inspect
            try:
                arg = next(iter(inspect.signature(fn).parameters))
            except (StopIteration, TypeError, ValueError):
                raise CompileError(
                    f"then({getattr(fn, '__name__', fn)!r}) could not infer "
                    f"the carry parameter — pass arg='<param name>'")
        extras = list(over) if over is not None else [{} for _ in self.specs]
        if len(extras) != len(self.specs):
            raise CompileError(
                f"then(over=...) must supply one kwargs dict per member: "
                f"got {len(extras)} for {len(self.specs)} members")
        points = []
        for s, extra in zip(self.specs, extras):
            if not isinstance(extra, dict):
                raise CompileError(
                    f"then 'over' entries must be kwargs dicts, got "
                    f"{type(extra).__name__}")
            if arg in extra:
                raise CompileError(
                    f"then 'over' entry shadows the carry parameter {arg!r}")
            points.append({arg: s.out, **extra})
        member_slots = slots if slots is not None else self.specs[0].slots
        backends = {s.backend for s in self.specs}
        backend = backends.pop() if len(backends) == 1 else None
        return ensemble(fn, over=points, name=name, slots=member_slots,
                        backend=backend, max_retries=max_retries,
                        duration_hint=duration_hint, fuse=fuse)


def ensemble(
    fn: Union[Callable[..., Any], str],
    over: Iterable[Dict[str, Any]],
    *,
    name: Optional[str] = None,
    slots: int = 1,
    backend: Union[None, str, Callable[[Dict[str, Any]], Optional[str]]] = None,
    max_retries: int = 0,
    duration_hint: Optional[float] = None,
    after: Union[None, Node, Future, Sequence[Union[Node, Future]]] = None,
    fuse: bool = True,
) -> Ensemble:
    """One task per parameter point; the paper's homogeneous ensemble.

    ``over`` is any iterable of kwargs dicts — typically :func:`sweep`, but
    explicit lists work too, and the dict values may be futures of earlier
    tasks. ``backend`` pins every member to a federation member (or is
    called per-point to pin heterogeneously). Members are named
    ``<name>-<i>``; when ``name`` is omitted the members are auto-named by
    the compiler's per-workflow counters (deterministic per compile — name
    ensembles explicitly in resumable adaptive rounds).

    ``fuse`` (default True): when ``fn`` is a :func:`repro.fusion.fusable`
    kernel, members are tagged with a fusion group key at compile time so a
    fusion-capable RTS (JaxRTS) executes congruent members as one batched
    device dispatch instead of one task per Python thread — with unchanged
    per-member completion, failure and resume semantics. ``fuse=False``
    opts the ensemble out (every member runs scalar). Functions without
    the marker are unaffected either way.
    """
    points = list(over)
    if not points:
        raise CompileError("ensemble(over=...) produced zero parameter "
                           "points — nothing to run")
    group_key = None
    if fuse and callable(fn):
        # deferred import: the api layer only needs the key computation,
        # and must stay importable without touching the fusion package
        from ..fusion.groups import fusion_group_key
        group_key = fusion_group_key
    specs = []
    for i, point in enumerate(points):
        if not isinstance(point, dict):
            raise CompileError(
                f"ensemble 'over' entries must be kwargs dicts, got "
                f"{type(point).__name__} at index {i}")
        member_backend = backend(point) if callable(backend) else backend
        fusion_group = (group_key(fn, point, slots=slots,
                                  backend=member_backend)
                        if group_key is not None else None)
        specs.append(TaskSpec(
            fn, kwargs=point, name=f"{name}-{i}" if name else None,
            slots=slots, backend=member_backend, max_retries=max_retries,
            duration_hint=duration_hint, after=after,
            fusion_group=fusion_group))
    return Ensemble(specs, name)


class Chain(Node):
    """Sequential composition; see :func:`chain`."""

    def __init__(self, items: List[Node]) -> None:
        self.items = items

    def futures(self) -> List[Future]:
        return self.items[-1].futures()


def chain(*items: Union[Node, Callable[..., Any]], name: Optional[str] = None
          ) -> Chain:
    """Run ``items`` strictly one after another.

    Nodes are sequenced with control dependencies. Bare callables are
    promoted to tasks that *consume the previous link's output* — so
    ``chain(make, transform, summarize)`` threads data through the three
    steps (the previous link's single future, or the list of them).
    """
    if not items:
        raise CompileError("chain() needs at least one item")
    out: List[Node] = []
    prev: Optional[Node] = None
    for i, item in enumerate(items):
        if isinstance(item, Node):
            node = item
            if prev is not None:
                _add_control_deps(node, prev)
        elif callable(item):
            args: Sequence[Any] = ()
            if prev is not None:
                pf = prev.futures()
                args = (pf[0] if len(pf) == 1 else list(pf),)
            node = TaskSpec(item, args=args,
                            name=f"{name}-{i}" if name else None)
        else:
            raise CompileError(
                f"chain items must be nodes or callables, got "
                f"{type(item).__name__} at position {i}")
        out.append(node)
        prev = node
    return Chain(out)


def _add_control_deps(node: Node, prev: Node) -> None:
    """Make every entry spec of ``node`` wait for ``prev``'s terminals."""
    deps = prev.futures()
    for spec in _entry_specs(node):
        spec.after = list(spec.after) + list(deps)


def _entry_specs(node: Node) -> List[TaskSpec]:
    if isinstance(node, TaskSpec):
        return [node]
    if isinstance(node, Ensemble):
        return list(node.specs)
    if isinstance(node, Chain):
        return _entry_specs(node.items[0])
    if isinstance(node, (Branch, Loop)):
        return [node.decision]
    raise CompileError(f"cannot sequence after {type(node).__name__}")


def gather(
    source: Union[Node, Future, Sequence[Union[Node, Future]]],
    fn: Callable[..., Any],
    *,
    name: Optional[str] = None,
    slots: int = 1,
    backend: Optional[str] = None,
    max_retries: int = 0,
) -> TaskSpec:
    """A reduction task: ``fn(list_of_results)`` over ``source``'s outputs."""
    futures = _as_future_list(source)
    if not futures:
        raise CompileError("gather() source has no outputs")
    return TaskSpec(fn, args=(list(futures),), name=name, slots=slots,
                    backend=backend, max_retries=max_retries)


# --------------------------------------------------------------------------- #
# Adaptive combinators
# --------------------------------------------------------------------------- #

class DecisionContext:
    """What a branch condition sees: the results it declared ``after=``."""

    __slots__ = ("results",)

    def __init__(self, results: List[Any]) -> None:
        self.results = results

    @property
    def value(self) -> Any:
        """The single input's result (convenience for 1-input decisions)."""
        return self.results[0] if len(self.results) == 1 else self.results


class LoopContext:
    """What a loop predicate/body sees.

    ``round`` — index of the round just finished (predicate) or about to be
    built (body); ``results`` — the finished round's terminal results
    (``None`` when building round 0); ``history`` — one results-list per
    finished round.
    """

    __slots__ = ("round", "results", "history")

    def __init__(self, round_: int, results: Optional[List[Any]],
                 history: List[List[Any]]) -> None:
        self.round = round_
        self.results = results
        self.history = history


class Branch(Node):
    """Runtime two-way decision; see :func:`branch`."""

    def __init__(self, cond, then, orelse, after, name: Optional[str]
                 ) -> None:
        self.name = name          # auto-assigned by the compiler when None
        self.cond = cond
        self.then = then
        self.orelse = orelse
        # the decision task: gathers the after-futures, carries the hook
        self.decision = TaskSpec("__collect__", args=(list(after),),
                                 name=f"{name}-decide" if name else None)
        self.decision.dynamic = self
        self.out = Future(self.decision, key=name)

    def futures(self) -> List[Future]:
        return [self.out]


def branch(
    cond: Callable[[DecisionContext], Any],
    then: BranchArm,
    orelse: BranchArm = None,
    *,
    after: Union[Node, Future, Sequence[Union[Node, Future]]],
    name: Optional[str] = None,
) -> Branch:
    """Append ``then`` or ``orelse`` at runtime, once ``after`` completed.

    ``cond`` runs inside the toolkit (a ``post_exec`` hook) on a
    :class:`DecisionContext` of the ``after`` results. Arms may be nodes,
    builders ``(ctx) -> node``, or ``None`` (do nothing). The branch's
    future resolves to the chosen arm's terminal results (or the decision
    inputs when the chosen arm is ``None``).
    """
    deps = _as_future_list(after)
    if not deps:
        raise CompileError("branch(after=...) must name at least one input")
    return Branch(cond, then, orelse, deps, name)


class Loop(Node):
    """Adaptive repetition; see :func:`repeat_until`."""

    def __init__(self, predicate, body, max_rounds: int, after,
                 name: Optional[str]) -> None:
        if max_rounds < 1:
            raise CompileError(f"repeat_until max_rounds must be >= 1, "
                               f"got {max_rounds}")
        self.name = name          # auto-assigned by the compiler when None
        self.predicate = predicate
        self.body = body
        self.max_rounds = max_rounds
        self.after = after
        # placeholder decision spec: stands for the whole loop in the unit
        # graph; the compiler replaces it with the per-round machinery
        self.decision = TaskSpec("__loop__",
                                 name=f"{name}-entry" if name else None,
                                 after=after)
        self.decision.dynamic = self
        self.out = Future(self.decision, key=name)

    def futures(self) -> List[Future]:
        return [self.out]


def repeat_until(
    predicate: Callable[[LoopContext], Any],
    body: BodyBuilder,
    *,
    max_rounds: int = 64,
    after: Union[None, Node, Future, Sequence[Union[Node, Future]]] = None,
    name: Optional[str] = None,
) -> Loop:
    """Repeat ``body`` rounds until ``predicate`` is satisfied.

    ``body(ctx)`` builds each round's sub-workflow (round 0 included;
    ``ctx.results is None`` there). When a round's tasks complete,
    ``predicate(ctx)`` decides — truthy stops the loop. Rounds are appended
    at runtime through the PST ``post_exec`` machinery, so their number is
    unknown before execution (the paper's §III-B adaptive ensembles).
    ``max_rounds`` bounds runaway loops. The loop future resolves to the
    final round's results.
    """
    if not callable(predicate) or not callable(body):
        raise CompileError("repeat_until(predicate, body) takes callables")
    return Loop(predicate, body, max_rounds, _as_future_list(after), name)
