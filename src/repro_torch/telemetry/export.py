"""Exports: Chrome-trace/Perfetto JSON and the telemetry.jsonl snapshot.

The Chrome-trace export writes complete (``ph: "X"``) events — Perfetto
and ``chrome://tracing`` nest them by timestamp containment per thread
track, which matches the tracer's per-thread depth bookkeeping. It is
written as ``torch.profiler``'s ``export_chrome_trace`` writes its own:
microseconds after ``baseTimeNanoseconds``, the Unix-epoch ns at the start
of the current 7,889,238 s interval (Kineto's chrome-trace base), on the
process id and native thread ids the profiler's CPU events carry. The two
files' ``traceEvents`` then share one timeline and one set of thread
tracks. Thread-name metadata events label the tracks
(``rts-fusion-drainer-0``, ``wfp-enqueue``, …) so a fused run reads like
the architecture diagram.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List

from .metrics import MetricsRegistry
from .tracer import SpanTracer


#: Kineto's chrome-trace base interval (``ChromeTraceBaseTime``), seconds
TRACE_BASE_INTERVAL_S = 7_889_238


def trace_base_ns() -> int:
    """The ``baseTimeNanoseconds`` a chrome trace written now carries."""
    step = TRACE_BASE_INTERVAL_S
    return int(time.time()) // step * step * 1_000_000_000


def chrome_trace_events(tracer: SpanTracer, base_ns: int = 0
                        ) -> List[Dict[str, Any]]:
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    threads: Dict[int, str] = {}
    for rec in tracer.snapshot():
        threads.setdefault(rec["tid"], rec.get("thread") or str(rec["tid"]))
        args = dict(rec.get("attrs") or {}, id=rec["id"],
                    parent=rec["parent"], uid=rec["uid"])
        ev: Dict[str, Any] = {
            "name": rec["name"], "cat": rec.get("cat") or "repro",
            "ph": rec.get("ph", "X"), "ts": (rec["ts"] - base_ns) / 1000.0,
            "pid": pid, "tid": rec["tid"], "args": args,
        }
        if ev["ph"] == "X":
            ev["dur"] = rec.get("dur", 0) / 1000.0
        else:
            ev["s"] = "t"                     # instant event, thread scope
        events.append(ev)
    for tid, name in threads.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    return events


def export_chrome_trace(tracer: SpanTracer, registry: MetricsRegistry,
                        path: str) -> str:
    base_ns = trace_base_ns()
    doc = {
        "traceEvents": chrome_trace_events(tracer, base_ns),
        "displayTimeUnit": "ms",
        "baseTimeNanoseconds": base_ns,
        "otherData": {
            "dropped_spans": tracer.dropped_spans,
            "exported_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
            "metrics": registry.snapshot(),
        },
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return path


def export_jsonl(tracer: SpanTracer, registry: MetricsRegistry,
                 path: str) -> str:
    """Journal-adjacent snapshot: one JSON line per metric, led by a meta
    line — the offline feed for the ROADMAP-4 cost model (per-kernel
    dispatch-latency quantiles without re-running anything)."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(json.dumps({
            "kind": "meta",
            "exported_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "spans_buffered": len(tracer),
            "dropped_spans": tracer.dropped_spans,
        }) + "\n")
        for rec in registry.jsonl_records():
            fh.write(json.dumps(rec, default=str) + "\n")
    return path
