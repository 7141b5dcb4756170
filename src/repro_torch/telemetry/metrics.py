"""Metrics registry: typed counters/gauges + streaming quantile histograms.

Metric handles are ALWAYS live (unlike spans, which record only while
:func:`repro_torch.telemetry.enabled` or a profiler records): a counter
increment costs one small lock — the same price the scattered
``fusion_stats`` dict increments used to pay, but race-free and shared
across threads by construction. This is what lets the registry replace
the TorchRTS stats dicts without changing hot-path cost.

Histograms bucket observations on a log scale (``GAMMA = 1.05`` — ≤5 %
relative error per bucket), so p50/p90/p99 are streaming estimates with
bounded memory: a value range spanning twelve decades needs < 600 buckets.
The bucket table is a plain dict keyed by integer bucket index, which also
makes histograms mergeable (``registry.quantiles(kernel)`` merges one
kernel's histograms across execution tiers).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: well-known histogram family: per-kernel device dispatch latency,
#: labeled ``kernel=<fn name>`` and ``tier=scalar|fused|chain|dag|shard``
DISPATCH_LATENCY = "rts_dispatch_latency_seconds"

GAMMA = 1.05
_LOG_GAMMA = math.log(GAMMA)


class Counter:
    """Monotonic counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


def _bucket_index(v: float) -> int:
    return int(math.ceil(math.log(v) / _LOG_GAMMA))


def _bucket_value(idx: int) -> float:
    return GAMMA ** idx


class Histogram:
    """Log-bucketed streaming histogram with quantile estimates."""

    __slots__ = ("_lock", "_buckets", "_zero", "_count", "_sum",
                 "_min", "_max")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._zero = 0                       # observations <= 0
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if v <= 0.0:
                self._zero += 1
            else:
                idx = _bucket_index(v)
                self._buckets[idx] = self._buckets.get(idx, 0) + 1

    # -- read side ---------------------------------------------------------- #

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _merge_from(self, other: "Histogram") -> None:
        with other._lock:
            buckets = dict(other._buckets)
            zero, count, total = other._zero, other._count, other._sum
            lo, hi = other._min, other._max
        with self._lock:
            for idx, c in buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + c
            self._zero += zero
            self._count += count
            self._sum += total
            if lo is not None and (self._min is None or lo < self._min):
                self._min = lo
            if hi is not None and (self._max is None or hi > self._max):
                self._max = hi

    def quantile(self, q: float) -> Optional[float]:
        """Streaming quantile estimate (≤5 % relative bucket error)."""
        with self._lock:
            if self._count == 0:
                return None
            rank = max(1, math.ceil(q * self._count))
            if rank <= self._zero:
                return 0.0
            cum = self._zero
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                if cum >= rank:
                    # geometric bucket midpoint; clamp into observed range
                    v = _bucket_value(idx) * (2.0 / (1.0 + GAMMA))
                    if self._max is not None:
                        v = min(v, self._max)
                    if self._min is not None:
                        v = max(v, self._min)
                    return v
            return self._max

    def quantiles(self) -> Dict[str, Optional[float]]:
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        out: Dict[str, Any] = dict(self.quantiles())
        out.update({"count": count, "sum": total,
                    "mean": (total / count) if count else None,
                    "min": lo, "max": hi})
        return out

    def _reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._zero = 0
            self._count = 0
            self._sum = 0.0
            self._min = self._max = None


LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, Any]) -> LabelsKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelsKey) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + body + "}"


class MetricsRegistry:
    """Thread-safe keyed store of typed metric handles.

    ``counter``/``gauge``/``histogram`` memoize on ``(name, labels)`` — the
    returned handle is shared by every caller, so concurrent increments
    from the packer and the drain threads land on one locked cell instead
    of racing a plain dict (the ``fusion_stats`` bug this replaces).
    ``reset()`` zeroes metrics IN PLACE: handles cached at module import
    keep working across test/benchmark resets.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, LabelsKey], Any] = {}

    def _get(self, kind: str, cls: type, name: str,
             labels: Dict[str, Any]) -> Any:
        key = (kind, name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls()
            return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    # -- bulk reads --------------------------------------------------------- #

    def collect(self, kind: str, name: str
                ) -> List[Tuple[Dict[str, str], Any]]:
        """Every metric of ``kind`` under ``name`` as (labels, handle)."""
        with self._lock:
            items = [(k, m) for k, m in self._metrics.items()
                     if k[0] == kind and k[1] == name]
        return [(dict(k[2]), m) for k, m in items]

    def quantiles(self, kernel: Optional[str] = None,
                  name: str = DISPATCH_LATENCY,
                  **labels: Any) -> Dict[str, Optional[float]]:
        """p50/p90/p99 for one histogram family.

        ``quantiles(kernel)`` is the acceptance-criteria spelling: merge
        the per-tier dispatch-latency histograms of one kernel and return
        its latency quantiles. Extra ``labels`` narrow the match (e.g.
        ``tier="shard"``).
        """
        if kernel is not None:
            labels = dict(labels, kernel=kernel)
        merged = Histogram()
        want = _labels_key(labels)
        for lbls, h in self.collect("histogram", name):
            have = _labels_key(lbls)
            if all(item in have for item in want):
                merged._merge_from(h)
        return dict(merged.quantiles(), count=merged.count)

    def kernels(self, name: str = DISPATCH_LATENCY) -> List[str]:
        """Every kernel label observed under the dispatch-latency family."""
        out = {lbls["kernel"] for lbls, _ in self.collect("histogram", name)
               if "kernel" in lbls}
        return sorted(out)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """JSON-able dump of every metric, keyed ``name{labels}``."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for (kind, name, lkey), m in items:
            full = name + _fmt_labels(lkey)
            if kind == "counter":
                out["counters"][full] = m.value
            elif kind == "gauge":
                out["gauges"][full] = m.value
            else:
                out["histograms"][full] = m.summary()
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (histograms as summary quantiles)."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
        lines: List[str] = []
        typed: set = set()
        for (kind, name, lkey), m in items:
            lbl = _fmt_labels(lkey)
            if kind == "counter":
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} counter")
                lines.append(f"{name}{lbl} {m.value}")
            elif kind == "gauge":
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name}{lbl} {m.value}")
            else:
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} summary")
                for q, qv in (("0.5", m.quantile(0.5)),
                              ("0.9", m.quantile(0.9)),
                              ("0.99", m.quantile(0.99))):
                    if qv is not None:
                        qkey = lkey + (("quantile", q),)
                        lines.append(f"{name}{_fmt_labels(qkey)} {qv:.9g}")
                lines.append(f"{name}_sum{lbl} {m.sum:.9g}")
                lines.append(f"{name}_count{lbl} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def jsonl_records(self) -> Iterable[Dict[str, Any]]:
        """One JSON-able record per metric (the telemetry.jsonl rows)."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
        for (kind, name, lkey), m in items:
            rec: Dict[str, Any] = {"kind": kind, "name": name,
                                   "labels": dict(lkey)}
            if kind in ("counter", "gauge"):
                rec["value"] = m.value
            else:
                rec.update(m.summary())
            yield rec

    def reset(self) -> None:
        """Zero every metric in place (cached handles stay valid)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()
