"""The program's own spans, for the ``program_span`` readers: the records
of ``repro_torch.telemetry``'s ring made while the profiler ran, which are
those of the traced stretch alone. The program records spans on every
thread while a profiler records, stamped in Unix-epoch ns (``ts``,
``dur``); each carries the ``uid`` of the EnTK task it serves. A program
without such spans leaves none, and the readers then return None."""

from __future__ import annotations

from typing import Dict, List, Optional


def profiled_spans() -> List[Dict]:
    """The ring's records made while a profiler recorded, oldest first."""
    from repro_torch import telemetry
    return [r for r in telemetry.TRACER.snapshot() if r.get("profiled")]


def task_turnover_ms(records: List[Dict], executable: str
                     ) -> Optional[float]:
    """Mean, over consecutive tasks of ``executable`` by start, of the start
    of task k+1's ``rts.task`` span less the end of task k's, in ms."""
    tasks = sorted((r["ts"], r["ts"] + r["dur"]) for r in records
                   if r["name"] == "rts.task"
                   and r["attrs"].get("executable") == executable)
    gaps = [nxt[0] - cur[1] for cur, nxt in zip(tasks, tasks[1:])]
    return 1e-6 * sum(gaps) / len(gaps) if gaps else None


def span_ms_per_task(records: List[Dict], name: str) -> Optional[float]:
    """The ``name`` spans' time a task (summed by ``uid``), averaged over
    the tasks that have one, in ms."""
    per_task: Dict = {}
    for r in records:
        if r["name"] == name:
            per_task[r["uid"]] = per_task.get(r["uid"], 0) + r["dur"]
    return 1e-6 * sum(per_task.values()) / len(per_task) if per_task else None
