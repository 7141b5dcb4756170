"""Where the card waits in the serve cell, by the program's own spans.

    python3 tools/trace_serve_spans.py [--batches 12] [--seed N] [--out PATH]
    python3 tools/trace_serve_spans.py --device cpu --smoke   # a rehearsal

Serves ``chatglm3-6b`` as the benchmark's ``chatglm3-6b.prefill`` cell does
(``perfbench/harness/serve_cell.py``'s closed-loop client: one EnTK task a
batch of 4 prompts of the cell's lengths, 1 new token, ``AppManager`` on
``TorchRTS``), warms every length it will send, then profiles ``--batches``
batches with ``torch.profiler`` (CPU and CUDA). The program's span ring
(``repro_torch.telemetry``) records on every thread while the profiler
runs, on the profiler's clock, so the two join on one timeline:

* each device idle gap of 20 µs or more (between the first and last host
  event, as the benchmark's breakdown takes them) is split in time by the
  ring spans open then: the innermost span of the RTS worker thread, else
  the latest-begun span open on the WFProcessor, ExecManager or scheduler
  threads, else none; beside it the label the benchmark's breakdown gives
  the gap (its own spans on the profiling thread);
* the turn between tasks (the end of task k's ``rts.task`` to the start of
  task k+1's) is split the same way over every thread's spans; what no span
  covers is the threads waking one another;
* each CUDA runtime call the profiler saw (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, …: thread id, time) is put down to the innermost
  ring span of its thread that holds it (it counts the calls whose thread
  id matched; the rest go to the worker's span open then).

Then it serves the same batches again with the ring on and no profiler:
the spans' times without the profiler's own cost. Prints the split and
writes it as JSON to ``--out``. Needs the card for the
device's gaps; ``--device cpu --smoke`` runs the same path on the port's
smoke model, where the profiler sees no device.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

from perfbench.harness import serve_cell, spans, trace, traffic  # noqa: E402

WORKER = "rts-worker"
TURN_REST = "rest (threads waking one another)"


def _span_list(records):
    return [dict(r, end=r["ts"] + r["dur"]) for r in records
            if r["ph"] == "X"]


def _open_at(spans_, t):
    return [s for s in spans_ if s["ts"] <= t < s["end"]]


def _gap_label(open_):
    """The innermost worker span, else the latest-begun span elsewhere."""
    work = [s for s in open_ if s["thread"].startswith(WORKER)]
    if work:
        return max(work, key=lambda s: (s["depth"], s["ts"]))["name"]
    if open_:
        return max(open_, key=lambda s: s["ts"])["name"]
    return "no span"


def _turn_label(open_):
    others = [s for s in open_ if s["name"] != "rts.task"]
    if not others:
        return TURN_REST
    return max(others, key=lambda s: (s["ts"], s["depth"]))["name"]


def split(a, b, spans_, label):
    """ns of [a, b) by the label of the spans open in each piece."""
    inside = [s for s in spans_ if s["ts"] < b and s["end"] > a]
    cuts = sorted({a, b} | {t for s in inside for t in (s["ts"], s["end"])
                            if a < t < b})
    out = collections.Counter()
    for lo, hi in zip(cuts, cuts[1:]):
        out[label(_open_at(inside, (lo + hi) // 2))] += hi - lo
    return out


def turns(tasks, ring):
    """The turn between consecutive tasks, split by span, ms a turn."""
    turn = collections.Counter()
    total = 0
    for cur, nxt in zip(tasks, tasks[1:]):
        turn += split(cur["end"], nxt["ts"], ring, _turn_label)
        total += nxt["ts"] - cur["end"]
    pairs = max(1, len(tasks) - 1)
    queued = [t["attrs"].get("queued_ns") for t in tasks[1:]]
    queued = [q for q in queued if q is not None]
    return {"turn_ms": total / pairs * 1e-6,
            "turn_ms_by_span": {k: v / pairs * 1e-6
                                for k, v in turn.most_common()},
            "queued_ms": (sum(queued) / len(queued) * 1e-6
                          if queued else None)}


def per_batch(tasks, ring, busy=()):
    """Each task's spans (ms) and the device's idle inside it."""
    rows = []
    for k, task in enumerate(tasks):
        row = {"task_ms": task["dur"] * 1e-6,
               "queued_ms": (task["attrs"].get("queued_ns") or 0) * 1e-6}
        for s in ring:
            if s["uid"] == task["uid"] and s["name"].startswith("serve."):
                row[s["name"][6:] + "_ms"] = s["dur"] * 1e-6
        if busy:
            inside = [(max(a, task["ts"]), min(b, task["end"]))
                      for a, b in busy if a < task["end"] and b > task["ts"]]
            row["idle_in_task_ms"] = sum(
                b - a for a, b in trace.gaps(inside, task["ts"], task["end"])
                if b - a >= trace.MIN_GAP_US * 1000) * 1e-6
        if k + 1 < len(tasks):
            row["turn_after_ms"] = (tasks[k + 1]["ts"] - task["end"]) * 1e-6
        rows.append(row)
    return rows


def summary(records, busy=()):
    """What a stretch's ring says: the two readers, each span's ms a batch,
    the turns and each batch (with the device's idle in it, given the
    device's ``busy`` intervals)."""
    ring = _span_list(records)
    tasks = sorted((s for s in ring if s["name"] == "rts.task"),
                   key=lambda s: s["ts"])
    return {"task_turnover_ms": spans.task_turnover_ms(records,
                                                       "reg://serve_batch"),
            "prefill_dispatch_ms": spans.span_ms_per_task(records,
                                                          "serve.prefill"),
            "span_ms_per_batch": {
                name: spans.span_ms_per_task(records, name) for name in (
                    "serve.generate", "serve.upload", "serve.prefill",
                    "serve.cache", "serve.sync", "serve.decode",
                    "serve.answer", "rts.task", "rts.deliver",
                    "rts.schedule")},
            **turns(tasks, ring), "per_batch": per_batch(tasks, ring, busy)}


def join(prof, records, idents):
    """The device's idle gaps, the turns and the runtime calls, by span."""
    base = prof.profiler.kineto_results.trace_start_ns()

    def ns(us):
        return base + round(us * 1000)

    events = prof.events()
    dev = [e for e in events if trace._is_device(e)]
    cpu = [e for e in events
           if e.device_type != torch.autograd.DeviceType.CUDA]
    ring = _span_list(records)
    out = {"batches": sum(s["name"] == "rts.task" for s in ring),
           "device_ops": len(dev)}

    # -- the device's idle gaps -------------------------------------------- #
    idle_by_span = collections.Counter()
    cross = collections.defaultdict(collections.Counter)
    if dev and cpu:
        lo = min(e.time_range.start for e in cpu)
        hi = max(e.time_range.end for e in cpu)
        iv = [(e.time_range.start, e.time_range.end) for e in dev]
        long = [(a, b) for a, b in trace.gaps(iv, lo, hi)
                if b - a >= trace.MIN_GAP_US]
        labels = trace._labels(cpu, [a for a, _ in long])
        for (a, b), bench_label in zip(long, labels):
            for name, t in split(ns(a), ns(b), ring, _gap_label).items():
                idle_by_span[name] += t
                cross[bench_label][name] += t
        out["window_s"] = (hi - lo) * 1e-6
        out["busy_s"] = trace.union_length(iv) * 1e-6
    out["idle_s_by_span"] = {k: v * 1e-9 for k, v in
                             idle_by_span.most_common()}
    out["idle_s_by_breakdown_label"] = {
        k: {n: t * 1e-9 for n, t in v.most_common()}
        for k, v in cross.items()}

    # -- runtime calls by the span that holds them ------------------------- #
    # Kineto's own events carry Unix-epoch ns and the calling thread's id
    # (``device_resource_id``: for a CUDA runtime call CUPTI's, the pthread
    # id cut to a signed 32-bit int; ``prof.events()`` carry neither). A
    # pthread id is reused by the next worker, so time picks the span.
    by_tid = collections.defaultdict(list)
    for s in ring:
        keys = {s["tid"]}
        if s["tid"] in idents:
            keys.add(ctypes.c_int32(idents[s["tid"]]).value)
        for key in keys:
            by_tid[key].append(s)
    calls = collections.defaultdict(lambda: [0, 0])
    matched = 0
    runtime = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() != torch.autograd.DeviceType.CUDA
               and e.name().startswith(("cuda", "cu"))]
    for e in runtime:
        mine = _open_at(by_tid.get(e.device_resource_id(), ()), e.start_ns())
        if mine:
            matched += 1
        else:                      # the call's thread id is not the ring's
            mine = [s for s in _open_at(ring, e.start_ns())
                    if s["thread"].startswith(WORKER)]
        name = max(mine, key=lambda s: s["depth"])["name"] if mine else (
            "no span")
        calls[f"{e.name()} in {name}"][0] += 1
        calls[f"{e.name()} in {name}"][1] += e.duration_ns()
    out["runtime_calls"] = len(runtime)
    out["runtime_calls_matched_by_thread"] = matched
    out["runtime_calls_by_span"] = {
        k: {"calls": n, "host_ms": t * 1e-6}
        for k, (n, t) in sorted(calls.items(), key=lambda kv: -kv[1][0])}

    out.update(summary(records, [(ns(e.time_range.start),
                                  ns(e.time_range.end)) for e in dev]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 4099)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from repro_torch import telemetry as tel
    from repro_torch.launch import serve as serve_mod

    dev = torch.device(args.device, 0) if args.device == "cuda" else (
        torch.device(args.device))
    mix = traffic.load(ROOT, "prefill_long")
    if args.smoke:
        mix.update(len_min=64, len_max=192, strata=3, batch=2)
    arch = "chatglm3-6b"
    t0 = time.perf_counter()
    sess = serve_mod.get_session(arch, args.smoke, str(dev))
    tokens = traffic.Tokens(sess.cfg.vocab_size, mix["tokens"])
    ctx = SimpleNamespace(mix=mix, seed=args.seed, device=dev, arch=arch,
                          smoke=args.smoke, seconds=0.0)
    lengths = {traffic.prompt_length(mix, args.seed, i)
               for i in range(args.batches + 1)}
    for n in sorted(lengths):
        sess.generate(tokens.rows(args.seed, 0xA11 + n, mix["batch"], n),
                      mix["max_new_tokens"])
    serve_cell.Client(ctx, tokens, 0.0, max_batches=1).run()
    trace._sync(dev)
    print(f"set-up {time.perf_counter() - t0:.1f} s; lengths "
          f"{sorted(lengths)}", flush=True)
    idents = {}
    generate = sess.generate

    def noting_thread(*a, **kw):
        idents[threading.get_native_id()] = threading.get_ident()
        return generate(*a, **kw)
    sess.generate = noting_thread
    tel.reset()
    probe = serve_cell.Client(ctx, tokens, float("inf"),
                              max_batches=args.batches)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    trace._sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        probe.run()
        trace._sync(dev)
    records = spans.profiled_spans()
    out = join(prof, records, idents)
    # the same batches with the ring on and no profiler: what it costs
    tel.reset()
    tel.enable()
    again = serve_cell.Client(ctx, tokens, float("inf"),
                              max_batches=args.batches)
    again.run()
    trace._sync(dev)
    tel.disable()
    out["unprofiled"] = dict(
        summary(tel.TRACER.snapshot()),
        batch_ms=[1e3 * (b["done"] - b["due"]) for b in again.batches])
    out.update(device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
               torch=torch.__version__, seed=args.seed,
               lengths=[b["length"] for b in probe.batches],
               ring_records=len(records),
               batch_ms=[1e3 * (b["done"] - b["due"]) for b in probe.batches])
    print(json.dumps(out, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
