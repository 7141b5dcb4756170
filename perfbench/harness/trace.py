"""Reading a ``torch.profiler`` window: device busy time, the device ops by
time, and the idle gaps by what the host was doing.

The benchmark wraps its calls into the program in ``record_function``
spans named ``perfbench.<layer call>``; a gap in the device's activity is
named by the innermost such span open on the host when it began, and the
innermost operator under it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Tuple

import torch

SPAN_PREFIX = "perfbench."
MIN_GAP_US = 20.0


def span(name: str):
    """A host span around a call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profile the block; yields a dict that holds, after the block, the
    reduction of the trace (:func:`reduce`)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out: Dict = {}
    _sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        _sync(device)
        t1 = time.perf_counter()
    out.update(reduce(prof.events(), t1 - t0))


def _is_device(ev) -> bool:
    """An op that ran on the device: a kernel, copy or fill, not the
    device-side image of a host span."""
    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith(SPAN_PREFIX))


def union_length(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def _label(active: List) -> str:
    """The innermost benchmark span and the innermost operator among the
    host events ``active`` (all open at one instant)."""
    if not active:
        return "host: outside the benchmark's spans"

    def length(e):
        return e.time_range.end - e.time_range.start
    ours = [e for e in active if e.name.startswith(SPAN_PREFIX)]
    inner = min(active, key=length)
    where = min(ours, key=length).name if ours else "no benchmark span"
    return where if inner.name == where else f"{where} > {inner.name}"


def _labels(cpu: List, instants: List[float]) -> List[str]:
    """:func:`_label` at each of the sorted ``instants``, in one sweep."""
    cpu = sorted(cpu, key=lambda e: e.time_range.start)
    out, active, i = [], [], 0
    for t in instants:
        while i < len(cpu) and cpu[i].time_range.start <= t:
            active.append(cpu[i])
            i += 1
        active = [e for e in active if e.time_range.end > t]
        out.append(_label(active))
    return out


def reduce(events, window_s: float) -> Dict:
    """busy_s (averaged over the devices that ran an op), window_s, device
    op count, device time by op name, the longest stretches in which no
    device ran an op by host activity, from the profiler's events."""
    dev = [e for e in events if _is_device(e)]
    cpu = [e for e in events
           if e.device_type != torch.autograd.DeviceType.CUDA]
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    by_dev: Dict[int, List] = collections.defaultdict(list)
    for e, i in zip(dev, iv):
        by_dev[e.device_index].append(i)
    busy = [union_length(v) * 1e-6 for v in by_dev.values()]
    by_name: Dict[str, float] = collections.Counter()
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    result = {"window_s": window_s, "device_ops": len(dev),
              "busy_s": sum(busy) / len(busy) if busy else 0.0,
              "busy_by_device": busy, "op_seconds": dict(by_name),
              "idle_gaps": []}
    if dev and cpu:
        lo = min(e.time_range.start for e in cpu)
        hi = max(e.time_range.end for e in cpu)
        idle: Dict[str, float] = collections.Counter()
        long = [(a, b) for a, b in gaps(iv, lo, hi) if b - a >= MIN_GAP_US]
        for (a, b), name in zip(long, _labels(cpu, [a for a, _ in long])):
            idle[name] += (b - a) * 1e-6
        result["idle_gaps"] = sorted(idle.items(), key=lambda kv: -kv[1])
    return result


def breakdown(trace: Dict) -> Dict:
    top = sorted(trace["op_seconds"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in trace["idle_gaps"][:10]]}
