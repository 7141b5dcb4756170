"""The port's fusion engine and TorchRTS carriers on the CPU: padding and
trimming, non-finite isolation, the degrade ladder, fault injection,
vmap dispatch, and all-or-nothing leases with a single front requeue —
the JAX package's engine semantics (``tests/test_fusion.py``)."""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.pst import Task
from repro_torch.fusion import ArrayResult, fusable
from repro_torch.fusion import engine as fengine
from repro_torch.rts.base import RequeueTask, ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

CPU = [torch.device("cpu")]


@fusable(static_argnames=("scale",))
def k_square(x, scale=1.0):
    x = torch.as_tensor(x, dtype=torch.float32)
    return x * x * scale


@fusable(static_argnames=("scale",), pad_argnames=("xs",))
def k_rowsum(xs, poison=0.0, scale=1.0):
    return torch.as_tensor(xs, dtype=torch.float32).sum(dim=1) * scale + poison


@fusable()
def k_touchy(x):
    # float() of a batched tensor raises under vmap (the whole batch), but
    # is fine scalar — exercising the engine's degrade-to-scalar isolation
    if float(x) >= 100.0:
        raise ValueError("bad member")
    return torch.as_tensor(x, dtype=torch.float32) + 1.0


@fusable(shared_argnames=("model",))
def k_shared(x, model=None):
    return (torch.as_tensor(model, dtype=torch.float32) * x).sum()


def _collect():
    done = []
    return done, done.append


def test_engine_pads_trims_and_isolates_nonfinite():
    tasks = []
    for i in range(6):
        n = 2 + (i % 3)
        tasks.append(Task(name=f"m{i}", executable=k_rowsum,
                          kwargs={"xs": [[float(i), 1.0]] * n,
                                  "poison": float("nan") if i == 4 else 0.0,
                                  "scale": 1.0}))
    done, deliver = _collect()
    stats = fengine.execute_fused(tasks, CPU, threading.Event(), deliver)
    assert stats["fused"] == 5 and stats["failed"] == 1
    assert stats["dispatches"] == 1
    by_uid = {c.uid: c for c in done}
    assert len(by_uid) == 6
    for i, t in enumerate(tasks):
        c = by_uid[t.uid]
        if i == 4:
            assert c.exit_code == 1 and "non-finite" in c.exception
            continue
        assert c.exit_code == 0
        vals = np.asarray(c.result)
        assert vals.shape == (2 + (i % 3),)     # padded rows trimmed back
        assert np.allclose(vals, float(i) + 1.0)
        assert isinstance(c.result, ArrayResult)  # device-resident handle


def test_engine_vmap_path_returns_host_scalars():
    tasks = [Task(name=f"s{i}", executable=k_square,
                  kwargs={"x": float(i), "scale": 2.0}) for i in range(5)]
    done, deliver = _collect()
    stats = fengine.execute_fused(tasks, CPU, threading.Event(), deliver)
    assert stats["fused"] == 5 and stats["dispatches"] == 1
    by_uid = {c.uid: c for c in done}
    assert [by_uid[t.uid].result for t in tasks] == [0.0, 2.0, 8.0, 18.0, 32.0]


def test_engine_exception_degrades_to_scalar_isolation():
    tasks = [Task(name=f"t{i}", executable=k_touchy, kwargs={"x": float(x)})
             for i, x in enumerate([1.0, 100.0, 2.0, 3.0])]
    done, deliver = _collect()
    stats = fengine.execute_fused(tasks, CPU, threading.Event(), deliver)
    assert stats["scalar_fallback"] == 3 and stats["failed"] == 1
    by_uid = {c.uid: c for c in done}
    assert [by_uid[t.uid].exit_code for t in tasks] == [0, 1, 0, 0]
    assert "bad member" in by_uid[tasks[1].uid].exception


def test_engine_rejects_mismatched_shared_args():
    m1 = np.ones(4, np.float32)
    m2 = np.full(4, 3.0, np.float32)
    tasks = [Task(name=f"sh{i}", executable=k_shared,
                  kwargs={"x": float(i + 1), "model": m1 if i < 2 else m2})
             for i in range(4)]
    done, deliver = _collect()
    stats = fengine.execute_fused(tasks, CPU, threading.Event(), deliver)
    assert stats["scalar_fallback"] == 4 and stats["fused"] == 0
    by_uid = {c.uid: c for c in done}
    vals = [float(by_uid[t.uid].result) for t in tasks]
    assert vals == [4.0, 8.0, 36.0, 48.0]   # each member's OWN model


def test_engine_honours_fault_injector_per_member():
    tasks = [Task(name=f"fi{i}", executable=k_square,
                  kwargs={"x": float(i), "scale": 1.0}) for i in range(5)]
    done, deliver = _collect()
    stats = fengine.execute_fused(
        tasks, CPU, threading.Event(), deliver,
        fault_injector=lambda t: t.name == "fi2")
    assert stats["failed"] == 1 and stats["fused"] == 4
    by_uid = {c.uid: c for c in done}
    assert by_uid[tasks[2].uid].exception == "injected fault"


def test_carrier_fault_degrades_without_losing_members(monkeypatch):
    tasks = [Task(name=f"cf{i}", executable=k_square,
                  kwargs={"x": float(i), "scale": 1.0}) for i in range(4)]
    done, deliver = _collect()
    monkeypatch.setattr(fengine, "CARRIER_FAULT", lambda exe: True)
    exe = fengine.ChainExecution([tasks], CPU, threading.Event(), deliver)
    exe.dispatch()
    stats = exe.drain()
    assert stats["degraded"] == 1 and stats["fused"] == 4
    assert sorted(c.result for c in done) == [0.0, 1.0, 4.0, 9.0]


def test_chain_execution_takes_one_link_only():
    with pytest.raises(ValueError, match="chain tier"):
        fengine.ChainExecution([[], []], CPU, threading.Event(),
                               lambda c: None)


def test_group_lease_all_or_nothing():
    rts = TorchRTS(devices=CPU * 2)
    rts.start(ResourceDescription(slots=2))
    try:
        carrier = Task(name="car", executable="fused://4", slots=2)
        with rts._pool_lock:
            stolen = rts._pool.pop()
        with pytest.raises(RequeueTask):
            rts._lease(carrier)
        assert rts.lease_requeues == 1
        with rts._pool_lock:
            assert len(rts._pool) == 1    # nothing leaked from the pool
            rts._pool.append(stolen)
    finally:
        rts.stop()


def test_fused_group_requeues_once_and_completes_under_churn():
    rts = TorchRTS(devices=CPU * 2, fusion_min_batch=2)
    rts._can_start = lambda task: True       # force the race window
    rts.start(ResourceDescription(slots=2))
    done = []
    all_done = threading.Event()
    members = [Task(name=f"w{i}", executable=k_square, slots=2,
                    kwargs={"x": float(i), "scale": 1.0},
                    tags={"_fusion_group": "W"}) for i in range(4)]
    want = {m.uid for m in members}

    def cb(c):
        done.append(c)
        if want <= {d.uid for d in done}:
            all_done.set()
    rts.set_callback(cb)
    with rts._pool_lock:
        stolen = rts._pool.pop()             # inventory goes short
    rts.submit(members)
    deadline = time.monotonic() + 5
    while rts.lease_requeues == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert rts.lease_requeues >= 1
    assert not done                          # no completion was fabricated
    with rts._lock:
        queued = list(rts._queue)
    assert len(queued) <= 1 and all(t.uid in rts._fused for t in queued)
    with rts._pool_lock:
        rts._pool.append(stolen)             # inventory recovers
    assert all_done.wait(10)
    rts.stop()
    assert {c.exit_code for c in done} == {0}
    assert len(done) == 4                    # every member exactly once
    assert rts.fusion_stats["fused"] == 4
