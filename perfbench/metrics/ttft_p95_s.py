"""The 95th percentile over every request of the window of the time from
when it was due to its first token (host clock); a failed request counts
as never answered."""

from perfbench.harness.readers import percentile, request_latencies


def read(run):
    if run.get("kind") != "serve":
        return None
    return percentile(request_latencies(run), 95.0)
