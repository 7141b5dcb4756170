"""Fault-tolerance policies: fault classes, retry/backoff, circuit breakers.

The stack grew two independent retry channels (paper §II-B.4 requires
fault tolerance; EnTK demonstrates it only for whole-pilot loss):

* **infra** — the pilot executing a task died (federation member failover,
  RTS restart). The task did nothing wrong: it is requeued unconditionally
  and the hop is journaled ``pilot_lost`` so resume never charges it.
* **task** — the task itself failed (nonzero exit, exception, non-finite
  output). Deterministic in expectation: each attempt consumes the task's
  retry budget.

:class:`RetryPolicy` names that split, makes both budgets explicit, and adds
exponential backoff with **deterministic** jitter (keyed hash of seed × task
× attempt — a chaos-seeded run replays the exact same schedule). The default
policy reproduces the historical behaviour bit-for-bit: task budget =
``task.max_retries`` (charged), infra unlimited (uncharged), zero backoff.

:class:`CircuitBreaker` / :class:`BreakerBoard` consume per-(kernel, tier)
failure outcomes so the JaxRTS trips the degrade ladder (composed → fused →
scalar) *proactively* instead of rediscovering a bad tier on every dispatch,
and re-closes after a probation window via a single half-open probe.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from .. import telemetry as tel

#: fault classes (the RetryPolicy budget key)
INFRA = "infra"    # pilot/member/RTS loss — not the task's fault
TASK = "task"      # the task's own failure — charged against its budget

#: telemetry families
RETRY_TOTAL = "retry_total"                        # {fault_class}
BREAKER_TRANSITIONS = "breaker_transitions_total"  # {kernel, tier, to}
BREAKER_SHORTCIRCUITS = "breaker_short_circuits_total"  # {kernel, tier}


def classify(msg: Dict[str, Any]) -> str:
    """Fault class of a failed completion message (Dequeue side)."""
    return INFRA if msg.get("pilot_lost") else TASK


def keyed_uniform(seed: int, *key: Any) -> float:
    """Deterministic uniform [0, 1) from a seed and a structured key.

    Order-independent across threads: the value depends only on the key,
    never on arrival order — the property that makes a seeded chaos run
    (and a jittered retry schedule) reproducible under concurrency."""
    h = hashlib.sha256(
        ":".join([str(seed)] + [str(k) for k in key]).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclass
class RetryPolicy:
    """Per-task retry budgets and backoff, keyed by fault class.

    ``max_task_retries`` of ``None`` defers to each task's own
    ``max_retries`` (the historical contract); ``max_infra_retries`` of
    ``None`` keeps infra requeues unlimited (failover must lose zero
    completions even for ``max_retries=0`` tasks). ``backoff_base=0``
    requeues immediately. ``deadline_s`` caps the total time a task may
    spend retrying, measured from its first failure.
    """

    max_task_retries: Optional[int] = None
    max_infra_retries: Optional[int] = None
    backoff_base: float = 0.0
    backoff_factor: float = 2.0
    backoff_max: float = 30.0
    jitter: float = 0.0           # ± fraction of the computed delay
    deadline_s: Optional[float] = None
    seed: int = 0

    def budget(self, task: Any, fault_class: str) -> Optional[int]:
        """Allowed retries for the class; None = unlimited."""
        if fault_class == INFRA:
            return self.max_infra_retries
        if self.max_task_retries is not None:
            return self.max_task_retries
        return getattr(task, "max_retries", 0)

    def should_retry(self, task: Any, fault_class: str, attempts: int,
                     first_failure_t: Optional[float] = None) -> bool:
        """True when attempt ``attempts + 1`` may run. ``attempts`` counts
        failures of this class already charged to the task."""
        if (self.deadline_s is not None and first_failure_t is not None
                and time.monotonic() - first_failure_t > self.deadline_s):
            return False
        budget = self.budget(task, fault_class)
        return budget is None or attempts < budget

    def delay(self, task_name: str, attempt: int) -> float:
        """Backoff before attempt ``attempt`` (1-based), with deterministic
        jitter keyed on (seed, task, attempt)."""
        if self.backoff_base <= 0:
            return 0.0
        d = min(self.backoff_max,
                self.backoff_base * self.backoff_factor ** max(0, attempt - 1))
        if self.jitter > 0:
            u = keyed_uniform(self.seed, "backoff", task_name, attempt)
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(0.0, d)


# --------------------------------------------------------------------------- #
# Circuit breakers
# --------------------------------------------------------------------------- #

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One (kernel, tier) breaker over the degrade ladder.

    closed → open after ``failure_threshold`` failures inside ``window_s``;
    open → half-open after ``probation_s`` (one probe dispatch allowed);
    half-open → closed on probe success, → open on probe failure. The clock
    is injectable so probation is testable without sleeping."""

    def __init__(self, failure_threshold: int = 3, window_s: float = 30.0,
                 probation_s: float = 5.0, clock=time.monotonic) -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.window_s = window_s
        self.probation_s = probation_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self._failures: list = []     # monotonic timestamps inside window
        self._opened_at = 0.0
        self._probing = False
        self.transitions: list = []   # [(to_state, t)] — the audit trail

    def _set(self, state: str) -> None:
        self.state = state
        self.transitions.append((state, self._clock()))

    def allow(self) -> bool:
        """May a dispatch use this tier right now?"""
        with self._lock:
            if self.state == CLOSED:
                return True
            now = self._clock()
            if self.state == OPEN and now - self._opened_at >= self.probation_s:
                self._set(HALF_OPEN)
                self._probing = True
                return True          # the single half-open probe
            if self.state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record(self, ok: bool) -> Optional[str]:
        """Record a dispatch outcome; returns the new state on transition."""
        with self._lock:
            now = self._clock()
            if self.state == HALF_OPEN:
                self._probing = False
                if ok:
                    self._failures.clear()
                    self._set(CLOSED)
                    return CLOSED
                self._opened_at = now
                self._set(OPEN)
                return OPEN
            if ok:
                return None
            self._failures.append(now)
            cutoff = now - self.window_s
            self._failures = [t for t in self._failures if t >= cutoff]
            if self.state == CLOSED \
                    and len(self._failures) >= self.failure_threshold:
                self._opened_at = now
                self._set(OPEN)
                return OPEN
            return None


class BreakerBoard:
    """Per-(kernel, tier) breakers with shared knobs + telemetry.

    ``allow(kernel, tier)`` is consulted at pack/compose time; ``record``
    at drain time. Tiers follow the execution ladder ("shard", "chain",
    "fused", "dag"); scalar execution is never gated — it is the floor the
    ladder degrades to. State transitions increment
    ``breaker_transitions_total{kernel, tier, to}`` and short-circuited
    dispatches ``breaker_short_circuits_total{kernel, tier}``."""

    def __init__(self, failure_threshold: int = 3, window_s: float = 30.0,
                 probation_s: float = 5.0, clock=time.monotonic,
                 registry: Optional[tel.MetricsRegistry] = None) -> None:
        self.failure_threshold = failure_threshold
        self.window_s = window_s
        self.probation_s = probation_s
        self._clock = clock
        self._registry = registry
        self._lock = threading.Lock()
        self._breakers: Dict[Tuple[str, str], CircuitBreaker] = {}

    def _counter(self, name: str, **labels: Any):
        reg = self._registry
        return (reg.counter(name, **labels) if reg is not None
                else tel.counter(name, **labels))

    def breaker(self, kernel: str, tier: str) -> CircuitBreaker:
        key = (kernel, tier)
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(self.failure_threshold, self.window_s,
                                   self.probation_s, clock=self._clock)
                self._breakers[key] = b
            return b

    def allow(self, kernel: Optional[str], tier: str) -> bool:
        if kernel is None:
            return True
        ok = self.breaker(kernel, tier).allow()
        if not ok:
            self._counter(BREAKER_SHORTCIRCUITS,
                          kernel=kernel, tier=tier).inc()
        return ok

    def record(self, kernel: Optional[str], tier: str, ok: bool) -> None:
        if kernel is None:
            return
        moved = self.breaker(kernel, tier).record(ok)
        if moved is not None:
            self._counter(BREAKER_TRANSITIONS,
                          kernel=kernel, tier=tier, to=moved).inc()

    def states(self) -> Dict[Tuple[str, str], str]:
        with self._lock:
            return {k: b.state for k, b in self._breakers.items()}
