"""The port's chaos plane on the CPU: every case of the JAX package's
``tests/test_chaos.py`` — seeded fault schedules across every layer
(kernel, carrier, member, journal, spill, socket, straggler), the unified
RetryPolicy, per-(kernel, tier) circuit breakers over ``TorchRTS``'s degrade
ladder, quantile-driven speculation, the seeded soak with zero lost
completions — on ``repro_torch``'s ``chaos``, ``core``, ``rts`` and
``serve`` modules, with ``TorchRTS(device="cpu")`` as the device RTS; and
the same seed telling the same failure story in both packages."""

import json
import socket as socketlib
import struct
import threading
import time
import warnings

import numpy as np

import torch

from repro_torch import api
from repro_torch import telemetry as tel
from repro_torch.chaos import CHAOS_INJECTED, FaultSchedule, FaultSpec
from repro_torch.core import AppManager, Pipeline, Stage, Task
from repro_torch.core import states as st
from repro_torch.core.journal import Journal
from repro_torch.core.policies import (INFRA, RETRY_TOTAL, TASK,
                                       BreakerBoard, CircuitBreaker,
                                       RetryPolicy, keyed_uniform)
from repro_torch.core.pst import register_executable
from repro_torch.fusion import engine as fengine
from repro_torch.fusion import fusable
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.local import LocalRTS
from repro_torch.rts.torch_rts import TorchRTS


# --------------------------------------------------------------------------- #
# Kernels (module-level: stable registration + stable telemetry labels)
# --------------------------------------------------------------------------- #

@fusable(static_argnames=("scale",))
def k_chaos_sq(x, scale=1.0):
    x = torch.as_tensor(x, dtype=torch.float32)
    return x * x * scale


def chaos_spec_kernel(i=0):
    return i


register_executable("chaos_serve_sq", k_chaos_sq)
register_executable("chaos_spec_kernel", chaos_spec_kernel)


def _stage_of(tasks, name="s0"):
    stg = Stage(name)
    stg.add_tasks(tasks)
    pipe = Pipeline(f"p-{name}")
    pipe.add_stages(stg)
    return pipe


def _flat(amgr):
    return [t for p in amgr.workflow for s in p.stages for t in s.tasks]


def _counter_value(name, **labels):
    return tel.counter(name, **labels).value


# --------------------------------------------------------------------------- #
# Determinism primitives
# --------------------------------------------------------------------------- #

def test_keyed_uniform_is_deterministic_and_order_free():
    a = keyed_uniform(7, "chaos", "kernel", "t3:0")
    b = keyed_uniform(7, "chaos", "kernel", "t3:0")
    assert a == b and 0.0 <= a < 1.0
    assert keyed_uniform(8, "chaos", "kernel", "t3:0") != a   # seed matters
    assert keyed_uniform(7, "chaos", "kernel", "t3:1") != a   # key matters


def test_fault_schedule_keys_per_attempt_and_logs_story():
    sched = FaultSchedule(3, {"kernel": 0.5})
    hits = [n for n in (f"t{i}" for i in range(40))
            if sched.fires("kernel", f"{n}:0")]
    assert 5 < len(hits) < 35                       # ~50% fire
    # same (site, key) answers identically; disabled sites never fire
    assert all(sched.fires("kernel", f"{n}:0") for n in hits)
    assert not sched.fires("carrier", "t0:0")
    # the story records what actually fired, sorted and seed-stable
    sched2 = FaultSchedule(3, {"kernel": 0.5})
    for n in (f"t{i}" for i in range(40)):
        sched2.fires("kernel", f"{n}:0")
    assert set(n for _, n in sched.story()) >= {f"{n}:0" for n in hits}
    assert [e for e in sched2.story() if e[0] == "kernel"] == sorted(
        {("kernel", f"{n}:0") for n in hits})


def test_fault_spec_params_reach_injectors():
    sched = FaultSchedule(1, [FaultSpec("straggler", 1.0,
                                        {"stall_s": 0.25})])
    inj = sched.straggler_injector()
    assert inj(Task(name="t0", executable="sleep://0")) == 0.25


# --------------------------------------------------------------------------- #
# RetryPolicy: budgets per fault class, backoff, deadline
# --------------------------------------------------------------------------- #

def test_retry_policy_default_matches_historical_contract():
    pol = RetryPolicy()
    t = Task(name="t", executable="sleep://0", max_retries=2)
    assert pol.budget(t, TASK) == 2
    assert pol.budget(t, INFRA) is None             # infra unlimited
    assert pol.should_retry(t, TASK, 1) and not pol.should_retry(t, TASK, 2)
    assert pol.should_retry(t, INFRA, 10_000)
    assert pol.delay("t", 1) == 0.0                 # no backoff by default


def test_retry_policy_budgets_backoff_and_deadline():
    pol = RetryPolicy(max_task_retries=5, max_infra_retries=2,
                      backoff_base=0.1, backoff_factor=2.0, backoff_max=0.35,
                      jitter=0.5, deadline_s=60.0, seed=9)
    t = Task(name="t", executable="sleep://0", max_retries=0)
    assert pol.should_retry(t, TASK, 4)             # policy overrides task's 0
    assert not pol.should_retry(t, INFRA, 2)        # infra capped
    # exponential, capped, deterministic jitter within ±50%
    d1, d2, d4 = pol.delay("t", 1), pol.delay("t", 2), pol.delay("t", 4)
    assert 0.05 <= d1 <= 0.15 and 0.1 <= d2 <= 0.3
    assert d4 <= 0.35 * 1.5
    assert d1 == pol.delay("t", 1)                  # replayable schedule
    # a first failure past the deadline stops further retries
    assert not pol.should_retry(t, TASK, 0,
                                time.monotonic() - 61.0)


def test_backoff_requeue_rides_timer_not_dequeue(tmp_path):
    """A retried task with backoff still completes, and the requeue went
    through the timer path (Dequeue is never blocked by a sleeping retry)."""
    flaky = {"left": 2}

    def inj(task):
        if flaky["left"] > 0:
            flaky["left"] -= 1
            return True
        return False

    amgr = AppManager(
        resources=ResourceDescription(slots=2),
        rts_factory=lambda: LocalRTS(fault_injector=inj),
        heartbeat_interval=0.1,
        retry_policy=RetryPolicy(backoff_base=0.05, backoff_max=0.1))
    amgr.workflow = [_stage_of(
        [Task(name="flaky", executable="sleep://0", max_retries=3)])]
    amgr.run(timeout=30)
    assert amgr.all_done
    [task] = _flat(amgr)
    assert task.retries == 2
    assert amgr.wfp.backoff_requeues == 2


# --------------------------------------------------------------------------- #
# Circuit breakers: trip, probation, half-open probe, re-close
# --------------------------------------------------------------------------- #

def test_breaker_trip_probation_and_reclose():
    clk = {"t": 0.0}
    brk = CircuitBreaker(failure_threshold=3, window_s=10.0, probation_s=5.0,
                         clock=lambda: clk["t"])
    assert brk.allow()
    for _ in range(2):
        assert brk.record(False) is None            # below threshold
    assert brk.state == "closed" and brk.allow()
    assert brk.record(False) == "open"              # third strike trips
    assert not brk.allow()                          # short-circuited
    clk["t"] = 4.9
    assert not brk.allow()                          # probation not elapsed
    clk["t"] = 5.1
    assert brk.allow()                              # the half-open probe
    assert not brk.allow()                          # ...and only one
    assert brk.record(True) == "closed"             # probe ok: re-close
    assert brk.allow()
    assert [s for s, _ in brk.transitions] == ["open", "half_open", "closed"]


def test_breaker_failed_probe_reopens_and_window_expires():
    clk = {"t": 0.0}
    brk = CircuitBreaker(failure_threshold=2, window_s=1.0, probation_s=1.0,
                         clock=lambda: clk["t"])
    brk.record(False)
    clk["t"] = 2.0                                  # first strike ages out
    assert brk.record(False) is None and brk.state == "closed"
    brk.record(False)                               # 2 inside window: trip
    assert brk.state == "open"
    clk["t"] = 3.1
    assert brk.allow()
    assert brk.record(False) == "open"              # failed probe: re-open
    assert not brk.allow()


def test_breaker_board_counts_transitions_and_short_circuits():
    clk = {"t": 0.0}
    reg = tel.MetricsRegistry()
    board = BreakerBoard(failure_threshold=1, window_s=10.0, probation_s=5.0,
                         clock=lambda: clk["t"], registry=reg)
    assert board.allow(None, "fused")               # no kernel: never gated
    assert board.allow("k", "fused")
    board.record("k", "fused", ok=False)
    assert not board.allow("k", "fused")
    assert board.states()[("k", "fused")] == "open"
    clk["t"] = 6.0
    assert board.allow("k", "fused")                # probe
    board.record("k", "fused", ok=True)
    assert board.states()[("k", "fused")] == "closed"
    snap = reg.snapshot()["counters"]
    assert snap['breaker_transitions_total{kernel="k",tier="fused",'
                'to="open"}'] == 1
    assert snap['breaker_transitions_total{kernel="k",tier="fused",'
                'to="closed"}'] == 1
    assert snap['breaker_short_circuits_total{kernel="k",tier="fused"}'] == 1


def test_open_breaker_degrades_torch_tier_without_losing_members():
    """A tripped 'fused' breaker short-circuits composition at pack time:
    members run scalar, every one completes, and the short-circuit is
    counted on the board's registry."""
    board = BreakerBoard(failure_threshold=1, probation_s=3600.0,
                         registry=tel.MetricsRegistry())
    board.record("k_chaos_sq", "fused", ok=False)   # pre-tripped
    holder = {}

    def factory():
        holder["rts"] = TorchRTS(device="cpu", slot_oversubscribe=4,
                               breakers=board)
        return holder["rts"]

    ens = api.ensemble(k_chaos_sq,
                       over=[{"x": float(i), "scale": 2.0} for i in range(8)],
                       name="brk")
    res = api.run(ens, resources=ResourceDescription(slots=4),
                  rts_factory=factory, timeout=60)
    try:
        assert all(v == st.DONE for v in res.task_states.values())
        for i, spec in enumerate(ens.specs):
            assert float(np.asarray(spec.out.result())) == 2.0 * i * i
        reg = board._registry.snapshot()["counters"]
        assert reg['breaker_short_circuits_total{kernel="k_chaos_sq",'
                   'tier="fused"}'] >= 1
    finally:
        res.close()


# --------------------------------------------------------------------------- #
# Carrier faults: the composed dispatch dies, the degrade ladder absorbs it
# --------------------------------------------------------------------------- #

def test_carrier_fault_degrades_without_losing_completions():
    sched = FaultSchedule(17, {"carrier": 1.0})
    holder = {}

    def factory():
        holder["rts"] = TorchRTS(device="cpu", slot_oversubscribe=4)
        return holder["rts"]

    prev = fengine.CARRIER_FAULT
    fengine.CARRIER_FAULT = sched.carrier_fault_injector()
    try:
        ens = api.ensemble(k_chaos_sq,
                           over=[{"x": float(i), "scale": 3.0}
                                 for i in range(8)], name="cf")
        res = api.run(ens, resources=ResourceDescription(slots=4),
                      rts_factory=factory, timeout=60)
        try:
            assert all(v == st.DONE for v in res.task_states.values())
            for i, spec in enumerate(ens.specs):
                assert float(np.asarray(spec.out.result())) == 3.0 * i * i
        finally:
            res.close()
    finally:
        fengine.CARRIER_FAULT = prev
    stats = holder["rts"].fusion_stats
    assert stats["degraded"] >= 1                   # ladder actually walked
    assert any(s == "carrier" for s, _ in sched.story())


# --------------------------------------------------------------------------- #
# Quantile-driven speculation (ROADMAP 4c)
# --------------------------------------------------------------------------- #

def test_speculation_fires_from_measured_p99():
    """With >= speculation_min_samples dispatch observations for a kernel,
    the watchdog thresholds at straggler_factor x measured p99 — no
    duration_hint needed — and the speculative clone rescues the stall."""
    label = "chaos_spec_kernel"
    for _ in range(70):
        tel.observe_dispatch(label, "scalar", 0.02)
    q = tel.quantiles(label)
    assert (q.get("count") or 0) >= 64

    stalled = []

    def inj(task):
        if task.name == "victim" and not stalled:
            stalled.append(task.uid)
            return 5.0
        return 0.0

    amgr = AppManager(
        resources=ResourceDescription(slots=4),
        rts_factory=lambda: LocalRTS(straggler_injector=inj),
        heartbeat_interval=0.05, straggler_factor=3.0,
        straggler_min_seconds=0.15)
    tasks = [Task(name="victim", executable="reg://chaos_spec_kernel",
                  kwargs={"i": 1})]
    tasks += [Task(name=f"fast{i}", executable="reg://chaos_spec_kernel",
                   kwargs={"i": i}) for i in range(3)]
    amgr.workflow = [_stage_of(tasks)]
    amgr.run(timeout=60)
    assert amgr.all_done
    assert amgr.emgr.speculations_from_quantile >= 1
    assert amgr.emgr.speculation_wins >= 1          # clone beat the stall


def test_speculation_cold_start_still_uses_hint():
    """Without quantile history the watchdog falls back to duration_hint
    (the pre-existing contract)."""
    stalled = []

    def inj(task):
        if task.name == "victim" and not stalled:
            stalled.append(task.uid)
            return 5.0
        return 0.0

    amgr = AppManager(
        resources=ResourceDescription(slots=4),
        rts_factory=lambda: LocalRTS(straggler_injector=inj),
        heartbeat_interval=0.05, straggler_factor=3.0,
        straggler_min_seconds=0.15)
    amgr.workflow = [_stage_of(
        [Task(name="victim", executable="sleep://0.01", duration_hint=0.01),
         Task(name="fast", executable="sleep://0.01", duration_hint=0.01)])]
    amgr.run(timeout=60)
    assert amgr.all_done
    assert amgr.emgr.speculations_from_hint >= 1


# --------------------------------------------------------------------------- #
# Serving: a dropped connection mid-submit must refund admission
# --------------------------------------------------------------------------- #

def test_socket_drop_mid_submit_refunds_admission():
    from repro_torch.serve import EnsembleService, ServiceDaemon

    sched = FaultSchedule(29, {"socket": 1.0})
    svc = EnsembleService(serve_hold_s=5.0, device="cpu").start()
    daemon = ServiceDaemon(svc, port=0).start()
    # the drop must land between admission and the accept response: a warm
    # daemon can answer before the client's close reaches it, so the
    # response waits for the drop (the submit itself runs unchanged)
    dropped = threading.Event()
    admit = svc.submit

    def submit_then_await_drop(*args, **kwargs):
        handle = admit(*args, **kwargs)
        dropped.wait(10)
        return handle

    svc.submit = submit_then_await_drop
    try:
        conn = socketlib.create_connection(("127.0.0.1", daemon.port),
                                           timeout=10)
        req = {"id": 1, "op": "submit", "tenant": "alice",
               "kernel": "reg://chaos_serve_sq",
               "sweep": [{"x": float(i), "scale": 1.0} for i in range(4)],
               "name": "m"}
        conn.sendall((json.dumps(req) + "\n").encode("utf-8"))
        assert sched.drops_socket("alice:1")
        # RST on close (SO_LINGER 0): the daemon's accept response hits a
        # dead socket and sendall raises — the abandon path must fire
        conn.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_LINGER,
                        struct.pack("ii", 1, 0))
        conn.close()
        dropped.set()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            snap = svc.admission.snapshot()
            if (daemon.abandoned_submits == 1
                    and snap.get("alice", {}).get("in_flight_members",
                                                  0) == 0):
                break
            time.sleep(0.02)
        assert daemon.abandoned_submits == 1
        snap = svc.admission.snapshot()
        assert snap.get("alice", {}).get("in_flight_members", 0) == 0
        assert snap.get("alice", {}).get("active_workflows", 0) == 0
        # the daemon is still healthy for the next tenant
        assert svc.stats()["active_submissions"] == 0
    finally:
        daemon.stop()
        svc.stop()


# --------------------------------------------------------------------------- #
# Spill corruption: the content hash rejects the bit-flip
# --------------------------------------------------------------------------- #

def test_corrupt_spill_flips_exactly_one_byte(tmp_path):
    spill = tmp_path / "w.spill"
    spill.mkdir()
    payload = bytes(range(64))
    (spill / "sha256-aaaa.npy").write_bytes(payload)
    sched = FaultSchedule(5, {"spill": 1.0})
    path = sched.corrupt_spill(str(spill))
    assert path is not None
    after = (spill / "sha256-aaaa.npy").read_bytes()
    assert len(after) == len(payload)
    assert sum(a != b for a, b in zip(after, payload)) == 1
    assert ("spill", "sha256-aaaa.npy") in sched.story()


# --------------------------------------------------------------------------- #
# The acceptance soak: 5% mixed faults across 4 layers, 1000 members
# --------------------------------------------------------------------------- #

#: the port's classes behind the soak; the cross-package check swaps in
#: the JAX package's
PORT = dict(FaultSchedule=FaultSchedule, AppManager=AppManager,
            Pipeline=Pipeline, Stage=Stage, Task=Task,
            ResourceDescription=ResourceDescription, LocalRTS=LocalRTS)


def _soak_run(seed, n=1000, journal_path=None, mods=PORT):
    m_ = mods
    sched = m_["FaultSchedule"](seed, {"kernel": 0.05, "member": 0.3,
                                       "straggler": 0.01, "journal": 1.0})
    victims = sched.pick_victims("member", [f"m{i}" for i in range(4)])
    rds = [m_["ResourceDescription"](slots=2, extra={"name": f"m{i}"})
           for i in range(4)]
    facts = [lambda: m_["LocalRTS"](
        fault_injector=sched.kernel_fault_injector(),
        straggler_injector=sched.straggler_injector(0.05))
        for _ in range(4)]
    amgr = m_["AppManager"](resources=rds, rts_factory=facts,
                            heartbeat_interval=0.1,
                            journal_path=journal_path, flush_every=1)
    stg = m_["Stage"]("s0")
    stg.add_tasks([m_["Task"](name=f"t{i}", executable="sleep://0.01",
                              max_retries=3) for i in range(n)])
    pipe = m_["Pipeline"]("p-s0")
    pipe.add_stages(stg)
    amgr.workflow = [pipe]

    def kill():
        time.sleep(0.4)
        for m in amgr.emgr.rts.members:
            if m.name in victims:
                m.rts.simulate_dead = True

    threading.Thread(target=kill, daemon=True).start()
    amgr.run(timeout=120)
    return amgr, sched, victims


def test_seeded_soak_zero_lost_completions_across_four_layers(tmp_path):
    jp = str(tmp_path / "soak.jsonl")
    infra0 = _counter_value(RETRY_TOTAL, fault_class=INFRA)
    task0 = _counter_value(RETRY_TOTAL, fault_class=TASK)
    kern0 = _counter_value(CHAOS_INJECTED, site="kernel")

    amgr, sched, victims = _soak_run(1100, journal_path=jp)

    # zero lost completions despite kernel faults + a member kill
    assert amgr.all_done
    assert victims == ["m1"]                        # seed-pinned failure story
    assert amgr.emgr.rts.members_lost == 1
    assert amgr.emgr.rts_restarts == 0              # absorbed below the Emgr

    # budget accounting per fault class: kernel faults charged to the tasks,
    # pilot loss charged to nobody
    flat = _flat(amgr)
    charged = sum(t.retries for t in flat)
    task_delta = _counter_value(RETRY_TOTAL, fault_class=TASK) - task0
    infra_delta = _counter_value(RETRY_TOTAL, fault_class=INFRA) - infra0
    assert charged == task_delta >= 1
    assert max(t.retries for t in flat) <= 3
    assert infra_delta >= 1
    assert _counter_value(CHAOS_INJECTED, site="kernel") - kern0 >= 1
    assert {s for s, _ in sched.story()} >= {"kernel", "member", "straggler"}

    # torn-tail crash recovery: tear the journal mid-record, then replay —
    # byte-stable (the truncation happens once) and state-complete
    assert sched.tear_journal(jp) > 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rep = Journal.replay(jp)
    bytes1 = open(jp, "rb").read()
    rep2 = Journal.replay(jp)
    assert open(jp, "rb").read() == bytes1
    assert rep2["state"] == rep["state"]
    done = sum(1 for (kind, _), s in rep["state"].items()
               if kind == "task" and s == st.DONE)
    assert done == 1000
    # replayed retry budgets never exceed what the live run charged
    assert all(v <= 3 for v in rep["retries"].values())


def test_same_seed_reproduces_the_same_failure_story():
    a_amgr, a_sched, _ = _soak_run(424, n=120)
    b_amgr, b_sched, _ = _soak_run(424, n=120)
    assert a_amgr.all_done and b_amgr.all_done
    assert a_sched.story() == b_sched.story()
    assert len(a_sched.story()) > 0
    assert (sum(t.retries for t in _flat(a_amgr))
            == sum(t.retries for t in _flat(b_amgr)))


# --------------------------------------------------------------------------- #
# Both packages: one seed, one failure story
# --------------------------------------------------------------------------- #

def test_same_seed_same_story_in_both_packages():
    """The JAX package's chaos plane and the port's, driving each package's
    own scheduler with the same seed, fire the same faults at the same
    keys and pick the same member victims."""
    import repro.chaos as jchaos
    from repro.core import AppManager as JAppManager
    from repro.core import Pipeline as JPipeline
    from repro.core import Stage as JStage
    from repro.core import Task as JTask
    from repro.rts.base import ResourceDescription as JResources
    from repro.rts.local import LocalRTS as JLocalRTS

    t_amgr, t_sched, t_victims = _soak_run(424, n=120)
    jmods = dict(FaultSchedule=jchaos.FaultSchedule, AppManager=JAppManager,
                 Pipeline=JPipeline, Stage=JStage, Task=JTask,
                 ResourceDescription=JResources, LocalRTS=JLocalRTS)
    j_amgr, j_sched, j_victims = _soak_run(424, n=120, mods=jmods)
    assert t_amgr.all_done and j_amgr.all_done
    assert t_victims == j_victims
    assert t_sched.story() == j_sched.story()
    assert len(t_sched.story()) > 0
    assert (sum(t.retries for t in _flat(t_amgr))
            == sum(t.retries for t in _flat(j_amgr)))
    # the pure decisions agree key by key, not only over a whole run
    for site in ("kernel", "member", "straggler", "carrier", "socket"):
        a = FaultSchedule(7, {site: 0.3})
        b = jchaos.FaultSchedule(7, {site: 0.3})
        keys = [f"t{i}:{i % 3}" for i in range(200)]
        assert ([a.fires(site, k) for k in keys]
                == [b.fires(site, k) for k in keys])
        assert (a.pick_victims(site, [f"m{i}" for i in range(8)])
                == b.pick_victims(site, [f"m{i}" for i in range(8)]))
