"""What the metric readers (``perfbench/metrics/``) share. Each reader
returns None where its run has nothing to read."""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

from .. import costs, reference


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the order statistics (numpy's
    default), over every value."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def request_latencies(run: Dict) -> List[float]:
    """Every request of the window: from when its batch was due to its
    answer; a failed request counts as never answered (infinite)."""
    out = []
    for b in run["window"]["batches"]:
        lat = b["done"] - b["due"] if b.get("ok") else math.inf
        out += [lat] * b["rows"]
    return out


def traced(run: Dict) -> Optional[Dict]:
    t = run.get("trace")
    return t if t and t.get("device_ops") else None


def idle_share(run: Dict) -> Optional[float]:
    t = traced(run)
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(run: Dict, kernel: str, names: str) -> Optional[float]:
    """Σ least time of the program's kernel ``kernel``'s calls in the
    traced stretch (the frozen cost formulas at each call's shape, from the
    program's shape counter) over Σ device time of the ops whose names
    match ``names``, in percent."""
    t = traced(run)
    shapes = (run.get("counters") or {}).get(kernel)
    if t is None or not shapes:
        return None
    pattern = re.compile(names)
    spent = sum(s for n, s in t["op_seconds"].items() if pattern.search(n))
    if spent <= 0:
        return None
    return 100.0 * costs.kernel_bound_s(kernel, shapes) / spent


def prefill_mfu(run: Dict) -> Optional[float]:
    """Model FLOPs of every prefill answered in the window (the reference's
    arithmetic, the output layer at each row's last position) over the
    window's seconds at the card's bf16 peak, in percent."""
    cfg, w = run["config"], run["window"]
    flops = reference.load(cfg["reference"]).forward_flops
    work = sum(flops(cfg, b["rows"], b["length"], b["rows"])
               for b in w["batches"] if b.get("ok"))
    return 100.0 * work / (w["seconds"] * costs.BF16_FLOPS_PER_S)
