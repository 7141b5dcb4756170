"""The ``program_span`` readers over hand-made records of the program's
ring: the values worked out by hand, and None without records."""

import pytest

from perfbench.harness import spans
from perfbench.run import load_reader

RUN = {"kind": "serve"}
MS = 1_000_000                                   # ns


def _rec(name, ts_ms, dur_ms, uid, profiled=True, **attrs):
    return {"ph": "X", "name": name, "cat": "", "ts": int(ts_ms * MS),
            "dur": int(dur_ms * MS), "tid": 1, "thread": "t", "depth": 0,
            "id": 0, "parent": None, "uid": uid, "profiled": profiled,
            "attrs": attrs}


def _task(k, start_ms, dur_ms, exe="reg://serve_batch"):
    return _rec("rts.task", start_ms, dur_ms, f"task.{k}", executable=exe,
                queued_ns=0)


@pytest.fixture
def ring():
    from repro_torch import telemetry as tel
    tel.TRACER.clear()
    yield tel.TRACER
    tel.TRACER.clear()


def _plant(ring, records):
    for r in records:
        ring._record(r)


def test_turnover_is_the_mean_gap_between_consecutive_tasks(ring):
    # tasks 0..2 end at 100, 205, 330 and start at 0, 104, 210: gaps 4, 5;
    # the task of another executable and the unprofiled one are left out
    _plant(ring, [_task(0, 0, 100), _task(1, 104, 101), _task(2, 210, 120),
                  _task(9, 150, 1, exe="reg://other"),
                  _rec("rts.task", 400, 1, "task.3", profiled=False,
                       executable="reg://serve_batch")])
    assert load_reader("task_turnover_ms.serve")(RUN) == pytest.approx(4.5)


def test_turnover_orders_tasks_by_start(ring):
    _plant(ring, [_task(1, 50, 10), _task(0, 0, 48)])
    assert load_reader("task_turnover_ms.serve")(RUN) == pytest.approx(2.0)


def test_dispatch_is_the_mean_prefill_span_a_batch(ring):
    # task a: 30 ms; task b: two spans, 10 + 14; the decode span is no
    # prefill: (30 + 24) / 2 = 27
    _plant(ring, [_rec("serve.prefill", 0, 30, "a"),
                  _rec("serve.prefill", 40, 10, "b"),
                  _rec("serve.prefill", 60, 14, "b"),
                  _rec("serve.decode", 80, 99, "b")])
    assert load_reader("prefill_dispatch_ms.serve")(RUN) == (
        pytest.approx(27.0))


@pytest.mark.parametrize("name", ["task_turnover_ms.serve",
                                  "prefill_dispatch_ms.serve"])
def test_without_records_the_readers_read_nothing(ring, name):
    assert load_reader(name)(RUN) is None
    # one task has no turn; records made with no profiler are not read
    _plant(ring, [_task(0, 0, 10),
                  _rec("serve.prefill", 0, 5, "a", profiled=False)])
    assert load_reader(name)(RUN) is None
    _plant(ring, [_task(1, 20, 10), _rec("serve.prefill", 20, 5, "b")])
    assert load_reader(name)({"kind": "train"}) is None


def test_the_helpers_take_records_directly():
    recs = [_task(0, 0, 10), _task(1, 13, 10), _task(2, 30, 1)]
    assert spans.task_turnover_ms(recs, "reg://serve_batch") == (
        pytest.approx(5.0))
    assert spans.task_turnover_ms(recs, "reg://other") is None
    assert spans.span_ms_per_task(recs, "rts.task") == pytest.approx(7.0)
    assert spans.span_ms_per_task([], "serve.prefill") is None
