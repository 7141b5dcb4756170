"""Unified telemetry plane: spans + metrics for every layer of the stack.

Two planes with different cost contracts:

* **Metrics** (:class:`MetricsRegistry`) are ALWAYS live. Counters and
  histograms replace the scattered stats dicts (``fusion_stats``,
  ``tenant_stats``) with thread-safe typed handles at the same hot-path
  price (one small lock per increment). The process-global ``REGISTRY``
  carries cross-cutting series — per-kernel dispatch-latency quantiles
  (:data:`~repro_torch.telemetry.metrics.DISPATCH_LATENCY`), jit-cache
  hit/miss, serve admission and queue waits; component-local registries
  (one per :class:`~repro_torch.rts.torch_rts.TorchRTS`) carry
  per-instance series.
* **Spans** (:class:`SpanTracer`) record while :func:`enabled` (turned on
  by :func:`enable` or ``REPRO_TELEMETRY=1`` in the environment) and while
  a ``torch.profiler`` is recording, on every thread, stamped on the
  profiler's clock (:mod:`.tracer`). With both off :func:`span` returns
  a shared no-op singleton, so an instrumentation point costs that check
  and keeps nothing. ``perfbench/run.py --trace 1`` profiles a stretch of
  a cell, and its ``program_span`` readers read the ring.

Exports: :func:`export_chrome_trace` (Perfetto-loadable JSON on the
profiler's timeline, so it overlays ``torch.profiler``'s own trace),
:func:`prometheus_text` (the serve protocol's ``metrics`` verb),
:func:`export_jsonl` (the journal-adjacent ``telemetry.jsonl`` snapshot).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from . import export as _export
from .metrics import (DISPATCH_LATENCY, Counter, Gauge,  # noqa: F401
                      Histogram, MetricsRegistry)
from .tracer import (DEFAULT_RING_SIZE, NOOP_SPAN, Span,  # noqa: F401
                     SpanTracer, torch_profiler)

__all__ = [
    "DISPATCH_LATENCY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "SpanTracer", "NOOP_SPAN", "REGISTRY", "TRACER",
    "enable", "disable", "enabled", "reset", "span", "event", "counter",
    "gauge", "histogram", "observe_dispatch", "quantiles", "kernels",
    "prometheus_text", "snapshot", "export_chrome_trace", "export_jsonl",
]

#: process-global registry (always live) and tracer (gated on enable())
REGISTRY = MetricsRegistry()
TRACER = SpanTracer()

_enabled = False


def enable(ring_size: Optional[int] = None) -> None:
    """Turn span tracing on (metrics are always on)."""
    global _enabled, TRACER
    if ring_size is not None and ring_size != TRACER.ring_size:
        TRACER = SpanTracer(ring_size=ring_size)
    TRACER.rebase()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    """The switch is on (a recording profiler records spans too)."""
    return _enabled


def reset() -> None:
    """Zero metrics in place and drop buffered spans (tests/benchmarks)."""
    REGISTRY.reset()
    TRACER.clear()


# -- hot-path helpers ------------------------------------------------------- #

def span(name: str, cat: str = "", **attrs: Any):
    """A context-managed span, or the shared no-op when tracing is off and
    no profiler records. ``uid=`` names the EnTK task it serves (else its
    parent's)."""
    if not (_enabled or torch_profiler._is_profiler_enabled):
        return NOOP_SPAN
    return TRACER.span(name, cat, attrs)


def event(name: str, cat: str = "", **attrs: Any) -> None:
    """An instant event on the trace timeline; no-op when tracing is off."""
    if _enabled or torch_profiler._is_profiler_enabled:
        TRACER.event(name, cat, **attrs)


def counter(name: str, **labels: Any) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: Any) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels: Any) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def observe_dispatch(kernel: str, tier: str, seconds: float) -> None:
    """Record one device-dispatch latency into the per-kernel family."""
    REGISTRY.histogram(DISPATCH_LATENCY, kernel=kernel, tier=tier) \
        .observe(seconds)


def quantiles(kernel: Optional[str] = None, **kw: Any
              ) -> Dict[str, Optional[float]]:
    return REGISTRY.quantiles(kernel, **kw)


def kernels() -> List[str]:
    return REGISTRY.kernels()


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def snapshot() -> Dict[str, Any]:
    out = REGISTRY.snapshot()
    out["tracing"] = {"enabled": _enabled, "spans_buffered": len(TRACER),
                      "dropped_spans": TRACER.dropped_spans}
    return out


def export_chrome_trace(path: str) -> str:
    return _export.export_chrome_trace(TRACER, REGISTRY, path)


def export_jsonl(path: str) -> str:
    return _export.export_jsonl(TRACER, REGISTRY, path)


if os.environ.get("REPRO_TELEMETRY", "").lower() in ("1", "true", "on"):
    enable()
