"""A batch's latency (due to answered, through AppManager and TorchRTS)
minus the session's own prefill seconds, averaged over the window's
batches, in ms."""


def read(run):
    if run.get("kind") != "serve":
        return None
    got = [b["done"] - b["due"] - b["prefill_s"]
           for b in run["window"]["batches"] if "prefill_s" in b]
    return 1e3 * sum(got) / len(got) if got else None
