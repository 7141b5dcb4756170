"""Thread-safe unique-id factory.

EnTK names entities ``<kind>.%04d`` within a session; we keep that convention
because journal replay and the profiler key on uids. ``reset()`` exists only
for tests and benchmarks that want reproducible uids.
"""

from __future__ import annotations

import itertools
import threading
from collections import defaultdict
from typing import Dict, Iterator

_lock = threading.Lock()
_counters: Dict[str, Iterator[int]] = defaultdict(itertools.count)


def generate(kind: str) -> str:
    with _lock:
        return f"{kind}.{next(_counters[kind]):04d}"


def reset() -> None:
    with _lock:
        _counters.clear()
