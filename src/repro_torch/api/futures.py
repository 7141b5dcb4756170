"""Data-flow primitives of the declarative API: TaskSpec and Future.

A :class:`TaskSpec` *describes* one task: a Python callable (or a synthetic
``sleep://`` executable), its arguments — which may contain :class:`Future`
placeholders for other specs' return values — and its resource requirements
(``slots``, ``backend`` federation affinity, ``max_retries``). Nothing runs
at description time; :func:`repro.api.compile` turns a graph of specs into
PST pipelines the unchanged scheduler core executes.

A :class:`Future` is the declared output of a spec (``spec.out``) or of an
adaptive combinator (``repeat_until``/``branch`` aggregates). Passing a
future as an argument to another spec *is* the dependency edge; after the
run, :meth:`Future.result` reads the produced value.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ..core.results import STORE
from .errors import CompileError

FnLike = Union[Callable[..., Any], str]


class Future:
    """A handle on a value that will exist once its producer has run.

    ``owner`` is the producing :class:`TaskSpec` (or the decision spec of an
    adaptive combinator); ``key`` overrides the store key for aggregate
    futures whose value is written under the combinator's own name rather
    than a task's.
    """

    __slots__ = ("owner", "key")

    def __init__(self, owner: "TaskSpec", key: Optional[str] = None) -> None:
        self.owner = owner
        self.key = key

    @property
    def name(self) -> str:
        """The store key this future resolves under (producer task name)."""
        return self.key if self.key is not None else self.owner.name

    def result(self) -> Any:
        """The produced value (valid once the producer completed).

        Raises :class:`~repro.core.exceptions.MissingError` before then.
        """
        ns = self.owner.ns
        if ns is None:
            raise CompileError(
                f"future {self.name!r} belongs to an uncompiled workflow — "
                f"call api.compile(...) and run it first")
        return STORE.get(ns, self.name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Future {self.name!r}>"


class Node:
    """Anything the compiler accepts: a spec or a combinator over specs."""

    def futures(self) -> List[Future]:
        """Terminal outputs of this node (what downstream consumers see)."""
        raise NotImplementedError


class TaskSpec(Node):
    """Declarative description of one task.

    ``fn`` is a Python callable (auto-registered for journal resume), a
    ``reg://name`` reference, or a synthetic executable string such as
    ``sleep://0.05`` (which cannot consume futures — there is no callable to
    hand the values to).

    ``name`` must be unique within one compiled workflow; unnamed specs get
    deterministic names at compile time (``<fn>-<seq>``), which keeps
    resume/replay stable as long as the description code itself is
    deterministic.
    """

    def __init__(
        self,
        fn: FnLike,
        args: Sequence[Any] = (),
        kwargs: Optional[Dict[str, Any]] = None,
        *,
        name: Optional[str] = None,
        slots: int = 1,
        backend: Optional[str] = None,
        max_retries: int = 0,
        duration_hint: Optional[float] = None,
        after: Union[None, Node, Future, Sequence[Union[Node, Future]]] = None,
        fusion_group: Optional[str] = None,
    ) -> None:
        if not callable(fn) and not isinstance(fn, str):
            raise CompileError(
                f"TaskSpec fn must be a callable or an executable string, "
                f"got {type(fn).__name__}")
        self.fn = fn
        self.args = list(args)
        self.kwargs = dict(kwargs or {})
        self.explicit_name = name
        self.name: Optional[str] = name   # finalized at compile time
        self.slots = slots
        self.backend = backend
        self.max_retries = max_retries
        self.duration_hint = duration_hint
        # fusion group key (repro.fusion): members of one homogeneous
        # ensemble share it, letting a fusion-capable RTS batch them into
        # a single device dispatch; None = never fuse
        self.fusion_group = fusion_group
        self.after = _as_future_list(after)
        self.out = Future(self)
        # compile-time bindings
        self.ns: Optional[str] = None     # workflow namespace once compiled
        self.task = None                  # the built core Task object
        self._claimed = False             # name registered with the compiler
        # adaptive combinators attach themselves here (compiler internals)
        self.dynamic = None
        # chain/DAG-fusion bindings (compiler internals): the Ensemble this
        # spec is a member of, and the CHAIN_TAG / DAG_TAG dict once
        # detection has placed the member on a fused chain or fused DAG
        self._ens = None
        self._chain_tag: Optional[Dict[str, Any]] = None
        self._dag_tag: Optional[Dict[str, Any]] = None

    # -- Node --------------------------------------------------------------- #

    def futures(self) -> List[Future]:
        return [self.out]

    def inputs(self) -> List[Future]:
        """Every future this spec consumes (data edges + control edges)."""
        found: List[Future] = []
        _walk_futures(self.args, found)
        _walk_futures(self.kwargs, found)
        found.extend(self.after)
        return found

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        fn = self.fn if isinstance(self.fn, str) else getattr(
            self.fn, "__qualname__", "fn")
        return f"<TaskSpec {self.name or self.explicit_name or fn!r}>"


def _as_future_list(value) -> List[Future]:
    """Normalize an ``after=`` argument into a flat list of futures."""
    if value is None:
        return []
    if isinstance(value, (Node, Future)):
        value = [value]
    out: List[Future] = []
    for v in value:
        if isinstance(v, Future):
            out.append(v)
        elif isinstance(v, Node):
            out.extend(v.futures())
        else:
            raise CompileError(
                f"after= entries must be futures or nodes, got "
                f"{type(v).__name__}")
    return out


def _walk_futures(value: Any, found: List[Future]) -> None:
    """Collect Future instances nested anywhere in args/kwargs containers."""
    if isinstance(value, Future):
        found.append(value)
    elif isinstance(value, Node):
        raise CompileError(
            f"{value!r} passed as a task argument — pass its output "
            f"(node.out / node.futures()) instead of the node itself")
    elif isinstance(value, (list, tuple)):
        for v in value:
            _walk_futures(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _walk_futures(v, found)
