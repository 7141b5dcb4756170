"""Span tracer: bounded-ring, monotonic-ns, nested spans with attrs.

Design constraints (ISSUE 9):

* **zero-cost-when-off** — the module-level :func:`repro.telemetry.span`
  helper returns a shared no-op singleton when tracing is disabled; the
  only cost at an instrumentation point is one attribute check. Nothing in
  this file runs unless tracing was explicitly enabled.
* **thread-safe, exact nesting** — span depth is tracked per thread in a
  ``threading.local`` stack, so concurrent begin/end from many threads can
  never interleave each other's nesting; the ring append takes one lock.
* **bounded memory** — completed spans land in a ring of ``ring_size``
  records; overflow drops the OLDEST record and increments
  ``dropped_spans`` (surfaced as a metric and in the Chrome-trace export),
  so a long-running service can keep tracing without unbounded growth.

Timestamps are ``time.monotonic_ns()`` — immune to wall-clock steps, and
exactly what the Chrome-trace ``ts``/``dur`` microsecond fields want after
a ``/1000``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_RING_SIZE = 65_536


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def end(self) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class Span:
    """One open span; closes via :meth:`end` or as a context manager."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "t0", "tid", "thread",
                 "depth", "_done")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 attrs: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        cur = threading.current_thread()
        self.tid = cur.ident or 0
        self.thread = cur.name
        self.depth = tracer._push_depth()
        self._done = False
        self.t0 = time.monotonic_ns()

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        dur = time.monotonic_ns() - self.t0
        self._tracer._pop_depth()
        self._tracer._record({
            "ph": "X", "name": self.name, "cat": self.cat, "ts": self.t0,
            "dur": dur, "tid": self.tid, "thread": self.thread,
            "depth": self.depth, "attrs": self.attrs,
        })

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.end()
        return False


class SpanTracer:
    """Thread-safe span recorder over a bounded ring buffer."""

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE) -> None:
        self.ring_size = max(1, ring_size)
        self._ring: deque = deque()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._dropped = 0

    # -- per-thread nesting ------------------------------------------------- #

    def _push_depth(self) -> int:
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        return depth

    def _pop_depth(self) -> None:
        self._local.depth = max(0, getattr(self._local, "depth", 1) - 1)

    # -- recording ---------------------------------------------------------- #

    def _record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) >= self.ring_size:
                self._ring.popleft()          # drop the OLDEST span
                self._dropped += 1
            self._ring.append(rec)

    def span(self, name: str, cat: str = "",
             attrs: Optional[Dict[str, Any]] = None) -> Span:
        return Span(self, name, cat, attrs if attrs is not None else {})

    def begin(self, name: str, cat: str = "", **attrs: Any) -> Span:
        """Explicit begin/end pairing (tests; non-lexical spans)."""
        return self.span(name, cat, attrs)

    def event(self, name: str, cat: str = "", **attrs: Any) -> None:
        """Instant event (a point on the timeline, no duration)."""
        cur = threading.current_thread()
        self._record({
            "ph": "i", "name": name, "cat": cat,
            "ts": time.monotonic_ns(), "dur": 0, "tid": cur.ident or 0,
            "thread": cur.name, "depth": getattr(self._local, "depth", 0),
            "attrs": attrs,
        })

    # -- introspection ------------------------------------------------------ #

    @property
    def dropped_spans(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Completed records, oldest first (copies — safe to mutate)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0
