"""Model FLOPs of every prefill answered in the window (the plain
reference's arithmetic) over the window's seconds at the bf16 peak, in
percent: the whole step's share of the card's peak."""

from perfbench.harness.readers import prefill_mfu


def read(run):
    if run.get("kind") != "serve":
        return None
    return prefill_mfu(run)
