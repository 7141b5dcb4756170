"""The port's span plane on the CPU: off, a span point is the shared no-op
and the EnTK serve path leaves the ring empty; under ``torch.profiler``
every thread's spans are recorded with their task's uid and their parents,
on the profiler's clock, the profiling thread's spans beside their
``record_function`` twins; the Chrome-trace export overlays the
profiler's own; nothing is recorded once the profiler has stopped."""

import json
import statistics
import threading
import time

import pytest
import torch

from repro_torch import telemetry as tel
from repro_torch.launch import serve

SERVE_CHILDREN = ("serve.upload", "serve.prefill", "serve.cache",
                  "serve.sync", "serve.decode", "serve.answer")


@pytest.fixture(autouse=True)
def clean_ring():
    tel.disable()
    tel.reset()
    yield
    tel.disable()
    tel.reset()


def _serve_two_batches():
    amgr = serve.run_managed("chatglm3-6b", n_batches=2, batch_size=2,
                             prompt_len=16, max_new_tokens=2, device="cpu")
    assert amgr.all_done
    return [t.uid for p in amgr.workflow for s in p.stages for t in s.tasks]


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _epoch_ns(prof, ev):
    base = prof.profiler.kineto_results.trace_start_ns()
    return (base + round(ev.time_range.start * 1000),
            base + round(ev.time_range.end * 1000))


def test_off_the_serve_path_records_nothing():
    assert not tel.enabled()
    _serve_two_batches()
    assert len(tel.TRACER) == 0
    assert tel.span("serve.prefill", "serve") is tel.NOOP_SPAN
    with tel.span("rts.task", "rts", uid="x") as sp:
        assert sp is tel.NOOP_SPAN
    assert len(tel.TRACER) == 0


def test_profiled_serve_records_every_thread_by_task():
    with _profile() as prof:
        uids = _serve_two_batches()
    recs = tel.TRACER.snapshot()
    assert recs and all(r["profiled"] for r in recs)
    main = threading.get_native_id()
    for uid in uids:
        mine = [r for r in recs if r["uid"] == uid]
        names = [r["name"] for r in mine]
        for name in ("rts.schedule", "rts.task", "rts.deliver",
                     "serve.generate") + SERVE_CHILDREN:
            assert names.count(name) == 1, (uid, name, names)
        assert all(r["tid"] != main for r in mine)
        task = next(r for r in mine if r["name"] == "rts.task")
        gen = next(r for r in mine if r["name"] == "serve.generate")
        assert task["attrs"]["executable"] == "reg://serve_batch"
        assert task["attrs"]["queued_ns"] > 0
        assert gen["parent"] == task["id"] and gen["tid"] == task["tid"]
        for r in mine:
            if r["name"] in SERVE_CHILDREN:
                assert r["parent"] == gen["id"]
                assert gen["ts"] <= r["ts"]
                assert r["ts"] + r["dur"] <= gen["ts"] + gen["dur"]
        assert task["ts"] <= gen["ts"]
        assert gen["ts"] + gen["dur"] <= task["ts"] + task["dur"]
    # the profiler itself sees no range of the worker threads
    names = {e.name for e in prof.events()}
    assert "serve.prefill" not in names and "rts.task" not in names
    assert "appmanager.setup" in names          # the profiling thread's


def _twins(n):
    with _profile() as prof:
        for i in range(n):
            with tel.span(f"twin.{i}", "test"):
                time.sleep(0.002)
    recs = {r["name"]: r for r in tel.TRACER.snapshot()}
    out = []
    for i in range(n):
        ev = next(e for e in prof.events() if e.name == f"twin.{i}")
        start, end = _epoch_ns(prof, ev)
        rec = recs[f"twin.{i}"]
        out.append((rec, start, end))
    return prof, out


def test_a_profiling_thread_span_lies_on_its_twin():
    _, twins = _twins(6)
    # on one clock the span's own times lie within its twin's, which
    # record_function's enter and exit widen (tens of µs under the
    # profiler); the first twin pays the first call, and any one can be
    # preempted, so the opening is held to 0.1 ms at the median
    opens = []
    for rec, start, end in twins[1:]:
        assert rec["tid"] == threading.get_native_id()
        assert start - 5_000 <= rec["ts"]
        assert rec["ts"] + rec["dur"] <= end + 5_000
        opens.append(rec["ts"] - start)
    assert statistics.median(opens) < 100_000, opens


def test_the_chrome_export_overlays_the_profilers(tmp_path):
    prof, _ = _twins(4)
    ours, theirs = tmp_path / "ring.json", tmp_path / "profiler.json"
    tel.export_chrome_trace(str(ours))
    prof.export_chrome_trace(str(theirs))
    a, b = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert a["baseTimeNanoseconds"] == b["baseTimeNanoseconds"]
    twins = {e["name"]: e for e in b["traceEvents"] if e.get("ph") == "X"}
    opens = []
    for ev in a["traceEvents"]:
        if ev["ph"] == "X" and ev["name"] != "twin.0":
            twin = twins[ev["name"]]
            assert (ev["pid"], ev["tid"]) == (twin["pid"], twin["tid"])
            assert ev["args"]["id"] and ev["args"]["parent"] is None
            opens.append(ev["ts"] - twin["ts"])                 # µs
    assert len(opens) == 3 and 0 <= statistics.median(opens) < 100.0


def test_nothing_is_recorded_after_the_profiler_stops():
    with _profile():
        with tel.span("inside", "test"):
            pass
    n = len(tel.TRACER)
    assert n == 1
    assert tel.span("after", "test") is tel.NOOP_SPAN
    tel.event("after", "test")
    _serve_two_batches()
    assert len(tel.TRACER) == n


def test_enable_records_without_a_profiler_and_nests_by_thread():
    tel.enable()
    seen = {}

    def worker(k):
        with tel.span("outer", "test", uid=f"u{k}") as outer:
            with tel.span("inner", "test") as inner:
                seen[k] = (outer.id, inner.parent, inner.uid)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert all(pid == oid and uid == f"u{k}"
               for k, (oid, pid, uid) in seen.items())
    recs = tel.TRACER.snapshot()
    assert len(recs) == 8 and not any(r["profiled"] for r in recs)
    assert abs(recs[0]["ts"] - time.time_ns()) < 60 * 10 ** 9
