"""The host's dispatch of the prefill step's ops: the mean ``serve.prefill``
span (the step's call to its return, with no wait for the card) a batch of
the traced stretch, in ms (the program's spans)."""

from perfbench.harness.spans import profiled_spans, span_ms_per_task


def read(run):
    if run.get("kind") != "serve":
        return None
    return span_ms_per_task(profiled_spans(), "serve.prefill")
