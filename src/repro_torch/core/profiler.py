"""Overhead profiler matching the paper's measurement taxonomy (§IV-A.2).

The paper decomposes the non-task time into named overheads:

* **EnTK Setup Overhead** — messaging infrastructure + component instantiation
  + description validation.
* **EnTK Management Overhead** — processing the application, translating tasks
  to/from RTS objects, communicating PST entities and control messages.
* **EnTK Tear-Down Overhead** — canceling components + shutting down messaging.
* **RTS Overhead** — RTS submission/management time.
* **RTS Tear-Down Overhead** — RTS cancellation/shutdown.
* **Data Staging Time** and **Task Execution Time**.

Components call ``prof.begin(cat)/prof.end(cat)`` (or the ``measure``
context manager) around the corresponding code paths; the benchmark harness
then reads ``prof.totals()`` to emit one row per experiment, exactly mirroring
Fig. 7's stacked bars.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, Tuple

# Canonical category names (keys of the Fig.-7 stacks).
ENTK_SETUP = "entk_setup"
ENTK_MANAGEMENT = "entk_management"
ENTK_TEARDOWN = "entk_teardown"
RTS_OVERHEAD = "rts_overhead"
RTS_TEARDOWN = "rts_teardown"
DATA_STAGING = "data_staging"
TASK_EXECUTION = "task_execution"

CATEGORIES = (
    ENTK_SETUP, ENTK_MANAGEMENT, ENTK_TEARDOWN,
    RTS_OVERHEAD, RTS_TEARDOWN, DATA_STAGING, TASK_EXECUTION,
)


class Profiler:
    """Thread-safe accumulating profiler.

    ``clock`` is injectable so the SimulatedRTS can report virtual durations
    for task execution / staging while real (wall) time is used for toolkit
    overheads — the same split the paper uses when it separates RTS-side from
    EnTK-side measures.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._open: Dict[Tuple[str, int], float] = {}

    # -- interval API -----------------------------------------------------#

    def begin(self, category: str) -> None:
        key = (category, threading.get_ident())
        with self._lock:
            self._open[key] = time.perf_counter()

    def end(self, category: str) -> float:
        key = (category, threading.get_ident())
        now = time.perf_counter()
        with self._lock:
            t0 = self._open.pop(key, None)
            if t0 is None:
                return 0.0
            dt = now - t0
            self._totals[category] += dt
            self._counts[category] += 1
            return dt

    @contextmanager
    def measure(self, category: str) -> Iterator[None]:
        self.begin(category)
        try:
            yield
        finally:
            self.end(category)

    def add(self, category: str, seconds: float, count: int = 1) -> None:
        """Directly accumulate a duration (used for virtual-time categories)."""
        with self._lock:
            self._totals[category] += seconds
            self._counts[category] += count

    # -- reads --------------------------------------------------------------#

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def report(self) -> str:
        totals = self.totals()
        lines = ["category,seconds"]
        for cat in CATEGORIES:
            lines.append(f"{cat},{totals.get(cat, 0.0):.6f}")
        for cat in sorted(set(totals) - set(CATEGORIES)):
            lines.append(f"{cat},{totals[cat]:.6f}")
        return "\n".join(lines)
