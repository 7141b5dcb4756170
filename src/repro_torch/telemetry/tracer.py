"""Span tracer: a bounded ring of nested spans, from every thread, on the
profiler's clock.

* **zero-cost-when-off** — the module-level :func:`repro_torch.telemetry.span`
  helper returns a shared no-op singleton unless tracing was enabled or a
  ``torch.profiler`` is recording; the only cost at an instrumentation
  point is that check. Nothing in this file runs otherwise.
* **every thread, exact nesting** — each thread keeps its own stack of open
  spans (``threading.local``), so concurrent begin/end from many threads
  never interleave each other's nesting. A record carries its ``id``, its
  ``parent`` (the span open on the same thread when it began) and the
  ``uid`` of the EnTK task it serves: given where the worker starts the
  task, inherited from the parent below it. A wait that crosses threads is
  an attribute of the span that ends it (``queued_ns`` on ``rts.task``).
* **one clock** — durations are ``time.monotonic_ns()``; a record's ``ts``
  is Unix-epoch ns, the clock ``torch.profiler`` stamps its events with
  (``kineto_results.trace_start_ns()`` plus an event's offset): monotonic
  ns plus one offset, taken when the tracer starts, is cleared or is
  enabled (:meth:`SpanTracer.rebase`). Ring spans and the profiler's
  events lie on one timeline. ``tid`` is the thread's native id, the one
  the profiler's own events carry.
* **the profiler's thread** — ``torch.profiler`` records ranges only on
  the thread that started it; there each span is also a
  ``record_function`` range of the same name, which the span's own times
  lie within. A record made while a profiler recorded has ``profiled``
  true.
* **bounded memory** — completed spans land in a ring of ``ring_size``
  records; overflow drops the OLDEST record and increments
  ``dropped_spans`` (surfaced as a metric and in the Chrome-trace export),
  so a long-running service can keep tracing without unbounded growth.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as torch_profiler

DEFAULT_RING_SIZE = 65_536

_IDS = itertools.count(1)


def profiling() -> bool:
    """A ``torch.profiler`` is recording (read from the module global that
    every thread sees; the C check is true only on the profiler's own
    thread)."""
    return torch_profiler._is_profiler_enabled


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
                 "depth", "_done", "id", "parent", "uid", "profiled",
                 "_twin")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 attrs: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.tid = threading.get_native_id()
        self.thread = threading.current_thread().name
        self.id = next(_IDS)
        stack = tracer._stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        uid = attrs.pop("uid", None)
        self.uid = uid if uid is not None else (
            up.uid if up is not None else None)
        self.depth = len(stack)
        stack.append(self)
        self._done = False
        self.profiled = profiling()
        self._twin = None
        if self.profiled and torch._C._autograd._profiler_enabled():
            self._twin = torch_profiler.record_function(name)
            self._twin.__enter__()
        self.t0 = time.monotonic_ns()

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        dur = time.monotonic_ns() - self.t0
        if self._twin is not None:
            self._twin.__exit__(None, None, None)
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self._tracer._record({
            "ph": "X", "name": self.name, "cat": self.cat,
            "ts": self.t0 + self._tracer.offset_ns, "dur": dur,
            "tid": self.tid, "thread": self.thread, "depth": self.depth,
            "id": self.id, "parent": self.parent, "uid": self.uid,
            "profiled": self.profiled, "attrs": self.attrs,
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
        self.offset_ns = 0
        self.rebase()

    def rebase(self) -> None:
        """Take the offset from monotonic to Unix-epoch ns anew (it moves
        only when the wall clock is stepped)."""
        self.offset_ns = time.time_ns() - time.monotonic_ns()

    # -- per-thread nesting ------------------------------------------------- #

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

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
        stack = self._stack()
        up = stack[-1] if stack else None
        self._record({
            "ph": "i", "name": name, "cat": cat,
            "ts": time.monotonic_ns() + self.offset_ns, "dur": 0,
            "tid": threading.get_native_id(),
            "thread": threading.current_thread().name, "depth": len(stack),
            "id": next(_IDS), "parent": up.id if up is not None else None,
            "uid": up.uid if up is not None else None,
            "profiled": profiling(), "attrs": attrs,
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
        self.rebase()
