"""repro.api — the declarative ensemble-description layer.

The paper's requirement (i) asks for "dedicated abstractions to support the
description and execution of ensemble applications". This package is that
abstraction: workflows are *described* as data-flow graphs — tasks declare
their inputs as futures of other tasks' outputs — plus combinators for the
recurring ensemble shapes, and :func:`compile` lowers the description onto
the unchanged PST core (event-driven scheduler, slot-aware submission,
federated RTS fleet with failover, write-ahead journal resume).

Quickstart::

    from repro_torch import api

    def simulate(x, noise):  # a plain function IS a task body
        return x * x + noise

    def reduce(values):
        return sum(values) / len(values)

    sims = api.ensemble(simulate, over=api.sweep(x=range(8), noise=[0.0]),
                        name="sim")
    stats = api.gather(sims, reduce, name="stats")
    result = api.run(stats)           # or: amgr.workflow = api.compile(stats)
    print(stats.out.result())

Adaptive ensembles (the paper's §III-B) use :func:`repeat_until` /
:func:`branch`; federated placement rides on ``backend=``; everything is
journal-resumable when task functions are module-level (deterministic
registration names) and adaptive rounds name their ensembles by round.
"""

from typing import Any, Dict, List, Optional, Union

from ..core.appmanager import AppManager
from ..core.exceptions import EnTKError
from ..rts.base import ResourceDescription
from .combinators import (Branch, DecisionContext, Ensemble, Loop,  # noqa: F401
                          LoopContext, branch, chain, ensemble, gather,
                          repeat_until, sweep)
from .compiler import Compiled, compile_workflow
from .errors import CompileError  # noqa: F401
from .futures import Future, Node, TaskSpec  # noqa: F401
from .runtime import ensure_registered  # noqa: F401

#: ``api.compile(...)`` is the documented spelling (the issue's contract);
#: the module-level name intentionally shadows the builtin inside this
#: namespace only.
compile = compile_workflow

task = TaskSpec  # ``api.task(fn, ...)`` reads naturally in descriptions


class RunResult:
    """What :func:`run` returns: the AppManager, compiled workflow and the
    overhead report, with the common questions as properties.

    Call :meth:`close` once futures have been read — it releases the
    workflow's results from the process-global store (long-lived processes
    running many workflows would otherwise grow without bound)."""

    def __init__(self, amgr: AppManager, compiled: Compiled,
                 overheads: Dict[str, float]) -> None:
        self.amgr = amgr
        self.compiled = compiled
        self.overheads = overheads

    @property
    def all_done(self) -> bool:
        return self.amgr.all_done

    @property
    def task_states(self) -> Dict[str, str]:
        return {t.name: t.state for p in self.amgr.workflow
                for s in p.stages for t in s.tasks}

    def close(self) -> int:
        return self.compiled.close()


def run(
    *nodes: Union[Node, Future],
    resources: Optional[Union[ResourceDescription,
                              List[ResourceDescription]]] = None,
    name: Optional[str] = None,
    timeout: float = 3600.0,
    resume: bool = False,
    chain: bool = True,
    min_chain: Optional[int] = None,
    shard: bool = True,
    dag: bool = True,
    **appmanager_kwargs: Any,
) -> RunResult:
    """Compile and execute a declarative workflow in one call.

    All keyword arguments beyond ``resources``/``name``/``timeout``/
    ``resume``/``chain``/``min_chain``/``shard``/``dag`` go to
    :class:`~repro.core.appmanager.AppManager` — ``rts_factory=`` for a
    specific runtime, a list of resource descriptions (plus optional
    factory list) for a federated fleet, ``journal_path=`` for
    durable/resumable runs. ``chain=False`` (or a higher ``min_chain``)
    opts out of cross-stage chain fusion; ``dag=False`` keeps
    ``@fusable_reduction`` gathers scalar (chains still fuse);
    ``shard=False`` opts out of SPMD mesh sharding on multi-device
    runtimes; ``fuse=False`` on an ensemble opts out of fusion entirely.
    """
    compile_kwargs: Dict[str, Any] = {"name": name, "chain": chain,
                                      "shard": shard, "dag": dag}
    if min_chain is not None:
        compile_kwargs["min_chain"] = min_chain
    compiled = compile_workflow(*nodes, **compile_kwargs)
    amgr = AppManager(resources=resources, **appmanager_kwargs)
    amgr.workflow = compiled
    overheads = amgr.run(resume=resume, timeout=timeout)
    if compiled.hook_errors:
        # a raising predicate/body/arm truncates the adaptivity while the
        # PST run itself "completes" — that must be loud, not an
        # all_done=True with a silently short loop
        raise EnTKError(
            f"workflow {compiled.name!r} completed but "
            f"{len(compiled.hook_errors)} adaptive hook(s) failed:\n"
            + "\n".join(compiled.hook_errors))
    return RunResult(amgr, compiled, overheads)
