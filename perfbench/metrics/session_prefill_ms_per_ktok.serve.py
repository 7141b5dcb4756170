"""The serve session's prefill seconds (its own host clock, after a sync)
over every prompt token of the window, in ms a thousand tokens."""


def read(run):
    if run.get("kind") != "serve":
        return None
    got = [b for b in run["window"]["batches"] if "prefill_s" in b]
    tokens = sum(b["rows"] * b["length"] for b in got)
    return 1e6 * sum(b["prefill_s"] for b in got) / tokens if tokens else None
