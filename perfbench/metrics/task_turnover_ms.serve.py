"""The turn between request batches inside the EnTK task path: the mean,
over consecutive ``reg://serve_batch`` tasks of the traced stretch, of the
start of task k+1's ``rts.task`` span less the end of task k's, in ms (the
program's spans, on the profiler's clock)."""

from perfbench.harness.spans import profiled_spans, task_turnover_ms


def read(run):
    if run.get("kind") != "serve":
        return None
    return task_turnover_ms(profiled_spans(), "reg://serve_batch")
