"""Unified telemetry plane: spans + metrics for every layer of the stack.

Two planes with different cost contracts:

* **Metrics** (:class:`MetricsRegistry`) are ALWAYS live. Counters and
  histograms replace the scattered stats dicts (``fusion_stats``,
  ``tenant_stats``) with thread-safe typed handles at the same hot-path
  price (one small lock per increment). The process-global ``REGISTRY``
  carries cross-cutting series — per-kernel dispatch-latency quantiles
  (:data:`~repro.telemetry.metrics.DISPATCH_LATENCY`), jit-cache hit/miss,
  serve admission and queue waits; component-local registries (one per
  JaxRTS) carry per-instance series.
* **Spans** (:class:`SpanTracer`) are gated on :func:`enabled` and
  zero-cost when off: :func:`span` returns a shared no-op singleton, so an
  instrumentation point costs one flag check. Enable with :func:`enable`,
  ``REPRO_TELEMETRY=1`` in the environment, or ``--trace`` on
  ``benchmarks/run.py``.

Exports: :func:`export_chrome_trace` (Perfetto-loadable JSON),
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
                     SpanTracer)

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
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Zero metrics in place and drop buffered spans (tests/benchmarks)."""
    REGISTRY.reset()
    TRACER.clear()


# -- hot-path helpers ------------------------------------------------------- #

def span(name: str, cat: str = "", **attrs: Any):
    """A context-managed span, or the shared no-op when tracing is off."""
    if not _enabled:
        return NOOP_SPAN
    return TRACER.span(name, cat, attrs)


def event(name: str, cat: str = "", **attrs: Any) -> None:
    """An instant event on the trace timeline; no-op when tracing is off."""
    if _enabled:
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
