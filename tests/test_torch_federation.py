"""The port's federation layer with ``TorchRTS(device="cpu")`` as the device
member: the JaxRTS cases of the JAX package's ``tests/test_federation.py``
(hard backend affinity, a start that does not mutate the caller's
description, the granted slots recorded from the pilot), and member
failover with zero lost completions in a mixed LocalRTS + TorchRTS fleet,
fused device work included."""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import AppManager, Pipeline, Stage, Task
from repro_torch.fusion import fusable
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.local import LocalRTS
from repro_torch.rts.torch_rts import TorchRTS


@fusable()
def k_fed_inc(x):
    return torch.as_tensor(x, dtype=torch.float32) + 1.0


def _flat(amgr):
    return [t for p in amgr.workflow for s in p.stages for t in s.tasks]


def _stage_of(tasks, name="s0"):
    stg = Stage(name)
    stg.add_tasks(tasks)
    pipe = Pipeline(f"p-{name}")
    pipe.add_stages(stg)
    return pipe


def _recorder(ran, name):
    def fi(task):
        ran.setdefault(name, []).append(task.name)
        return False
    return fi


def _cpu_rts(slots=2, **kw):
    return TorchRTS(device="cpu", slot_oversubscribe=slots, **kw)


def test_backend_affinity_is_hard():
    """Tasks pinned to the device member never spill to the CPU member."""
    ran = {}
    rds = [ResourceDescription(slots=2, extra={"name": "cpu"}),
           ResourceDescription(slots=2, extra={"name": "acc"})]
    facts = [lambda: LocalRTS(fault_injector=_recorder(ran, "cpu")),
             lambda: _cpu_rts(fault_injector=_recorder(ran, "acc"))]
    amgr = AppManager(resources=rds, rts_factory=facts,
                      heartbeat_interval=0.2)
    acc_tasks = [Task(name=f"a{i}", executable="sleep://0.05", backend="acc")
                 for i in range(4)]
    free_tasks = [Task(name=f"f{i}", executable="sleep://0.05")
                  for i in range(4)]
    amgr.workflow = [_stage_of(acc_tasks + free_tasks)]
    amgr.run(timeout=30)
    assert amgr.all_done
    assert {n for n in ran.get("cpu", [])}.isdisjoint(
        {t.name for t in acc_tasks}), ran
    assert {t.name for t in acc_tasks} <= set(ran.get("acc", [])), ran


def test_torch_rts_start_does_not_mutate_callers_description():
    rd = ResourceDescription(slots=16, extra={"k": "v"})
    rts = _cpu_rts()
    pilot = rts.start(rd)
    try:
        assert rd.slots == 16                    # caller's object untouched
        assert pilot.description.slots == 2      # granted via the pilot
        assert pilot.description.extra == {"k": "v"}
        assert rts.free_slots() == 2
    finally:
        rts.stop()


def test_emgr_records_granted_slots_from_pilot():
    """The Emgr observes the clamped grant even though the RTS does not
    mutate the caller's description."""
    rd = ResourceDescription(slots=16)
    amgr = AppManager(resources=rd, rts_factory=_cpu_rts,
                      heartbeat_interval=0.2)
    amgr.workflow = [_stage_of([Task(name=f"g{i}", executable="sleep://0.02")
                                for i in range(4)])]
    amgr.run(timeout=30)
    assert amgr.all_done
    assert amgr.resources.slots == 2   # toolkit bookkeeping: granted
    assert rd.slots == 16              # the caller's object: untouched


@pytest.mark.parametrize("victim", ["local1", "torch1"])
def test_mixed_fleet_member_failover_zero_lost_completions(victim):
    """Kill one member of a LocalRTS + TorchRTS fleet mid-run: every task —
    scalar sleeps and fused device members alike — still reaches DONE, no
    whole-RTS restart is triggered, and pilot failover never consumes the
    tasks' own retry budgets."""
    names = ["local0", "local1", "torch0", "torch1"]
    rds = [ResourceDescription(slots=2, extra={"name": n}) for n in names]
    facts = [LocalRTS, LocalRTS, _cpu_rts, _cpu_rts]
    amgr = AppManager(resources=rds, rts_factory=facts,
                      heartbeat_interval=0.1)
    sleeps = [Task(name=f"k{i}", executable="sleep://0.3") for i in range(16)]
    fused = [Task(name=f"d{i}", executable=k_fed_inc, kwargs={"x": float(i)},
                  tags={"_fusion_group": "fed-inc"}) for i in range(8)]
    amgr.workflow = [_stage_of(sleeps + fused)]

    def kill():
        # kill the victim while it holds work, so that work must fail over
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            fed = getattr(amgr.emgr, "rts", None)
            rts = next((m.rts for m in getattr(fed, "members", ())
                        if m.name == victim), None)
            if rts is not None and rts.in_flight():
                rts.simulate_dead = True
                return
            time.sleep(0.01)

    threading.Thread(target=kill, daemon=True).start()
    amgr.run(timeout=60)
    fed = amgr.emgr.rts
    assert amgr.all_done
    assert fed.members_lost == 1
    assert fed.pilot_lost_requeues >= 1        # in-flight work was requeued
    assert amgr.emgr.rts_restarts == 0         # absorbed below the Emgr
    assert all(t.retries == 0 for t in _flat(amgr))
    for i, t in enumerate(fused):
        assert float(np.asarray(t.result).reshape(-1)[0]) == i + 1.0
