"""The port's chain tier on the CPU: the chain cases of the JAX package's
``tests/test_fusion.py`` (detection, the Emgr's whole-chain hold, composed
values equal to scalar, non-finite and exception isolation, fail-stage,
upstream retry, cancel of an undrained carrier) and its two mid-chain
resume cases (``tests/test_api_resume.py``), each on
``TorchRTS(device="cpu")``."""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import AppManager
from repro_torch.core import states as st
from repro_torch.core.exceptions import EnTKError
from repro_torch.core.journal import Journal
from repro_torch.core.pst import Task
from repro_torch.fusion import fusable
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

CHAIN_TAG = "_fusion_chain"


# --------------------------------------------------------------------------- #
# Kernels (module-level: resume-stable registration)
# --------------------------------------------------------------------------- #

def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


@fusable(static_argnames=("scale",))
def k_square(x, scale=1.0):
    return _f32(x) * _f32(x) * scale


@fusable(static_argnames=("scale",))
def k_vector(x, poison=0.0, scale=1.0):
    return torch.ones(3) * (_f32(x) * scale) + poison


@fusable()
def k_touchy(x):
    # float() of a batched tensor raises under vmap (the whole composed
    # segment dies), but is fine scalar — the degrade ladder's test
    if float(x) >= 100.0:
        raise ValueError("bad member")
    return _f32(x) + 1.0


def _rts(**kw):
    return TorchRTS(device="cpu", slot_oversubscribe=kw.pop("slots", 4), **kw)


def _two_link(fuse=True, n=4):
    e0 = api.ensemble(k_square,
                      over=[{"x": float(i), "scale": 2.0} for i in range(n)],
                      name="d0", fuse=fuse)
    return e0.then(k_square, name="d1", fuse=fuse)


def _task_named(res, name):
    return next(t for p in res.amgr.workflow for s in p.stages
                for t in s.tasks if t.name == name)


# --------------------------------------------------------------------------- #
# Detection and the Emgr's whole-chain hold
# --------------------------------------------------------------------------- #

def test_chain_detection_tags_and_opt_outs():
    compiled = api.compile(_two_link(), name="wf-ct")
    tags = {t.name: t.tags.get(CHAIN_TAG)
            for p in compiled for s in p.stages for t in s.tasks}
    cids = set()
    for i in range(4):
        t0, t1 = tags[f"d0-{i}"], tags[f"d1-{i}"]
        assert t0 == {"c": t0["c"], "k": 0, "m": i, "n": 2}
        assert t1 == {"c": t0["c"], "k": 1, "m": i, "n": 2, "a": "x"}
        cids.add(t0["c"])
    assert len(cids) == 1
    compiled.close()

    for kwargs, builder in (
            ({"chain": False}, lambda: _two_link()),
            ({"min_chain": 3}, lambda: _two_link()),
            ({}, lambda: _two_link(fuse=False))):
        compiled = api.compile(builder(), name=f"wf-ct-off-{kwargs}",
                               **kwargs)
        assert all(t.tags.get(CHAIN_TAG) is None
                   for p in compiled for s in p.stages for t in s.tasks)
        compiled.close()


def test_chain_detection_rejects_non_elementwise_shapes():
    e0 = api.ensemble(k_square, over=[{"x": float(i)} for i in range(4)],
                      name="nc0")
    mixed = api.ensemble(
        k_square, over=[{"x": [e0.specs[i].out, e0.specs[(i + 1) % 4].out]}
                        for i in range(4)], name="nc1")
    e2 = api.ensemble(k_square, over=[{"x": float(i)} for i in range(4)],
                      name="nc2")
    rot = api.ensemble(
        k_square, over=[{"x": e2.specs[(i + 1) % 4].out} for i in range(4)],
        name="nc3")
    for node, name in ((mixed, "wf-ncx"), (rot, "wf-ncr")):
        compiled = api.compile(node, name=name)
        assert all(t.tags.get(CHAIN_TAG) is None
                   for p in compiled for s in p.stages for t in s.tasks)
        compiled.close()


def _emgr_with_backlog(tasks):
    from repro_torch.core.broker import Broker
    from repro_torch.core.execmanager import ExecManager
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.pst import WorkflowIndex
    from repro_torch.core.state_service import StateService
    broker = Broker()
    broker.declare("pending")
    emgr = ExecManager(broker, StateService(broker), Profiler(),
                       lambda: None, ResourceDescription(slots=4),
                       WorkflowIndex())
    for t in tasks:
        emgr._backlog.setdefault(t.slots, collections.deque()).append(
            (next(emgr._backlog_seq), t))
        emgr._backlog_uids.add(t.uid)
    return emgr


def test_emgr_holds_incomplete_chain_then_drains_whole_on_one_charge():
    def link(k, m, n=3):
        return Task(name=f"c{k}m{m}", executable="sleep://0",
                    tags={"_fusion_group": f"G{k}",
                          CHAIN_TAG: {"c": "C", "k": k, "m": m, "n": n,
                                      "ss": n - 1}})

    emgr = _emgr_with_backlog([link(k, m) for k in range(2)
                               for m in range(4)])
    emgr._has_chain_backlog = True
    assert emgr._pick_batch_locked(free=4, fusion=True) == []
    assert emgr.n_backlogged() == 8
    for m in range(4):
        t = link(2, m)
        emgr._backlog.setdefault(t.slots, collections.deque()).append(
            (next(emgr._backlog_seq), t))
        emgr._backlog_uids.add(t.uid)
    batch = emgr._pick_batch_locked(free=1, fusion=True)
    assert len(batch) == 12 and emgr.n_backlogged() == 0


# --------------------------------------------------------------------------- #
# Composed execution
# --------------------------------------------------------------------------- #

def test_chain_fused_run_matches_scalar_values_and_states():
    def run(fuse, chain):
        e0 = api.ensemble(k_square,
                          over=[{"x": float(i), "scale": 2.0}
                                for i in range(12)], name="ch0", fuse=fuse)
        e1 = e0.then(k_square, name="ch1", fuse=fuse)
        e2 = e1.then(k_square, name="ch2", fuse=fuse)
        # float64 sum of the float32 member values on both paths
        total = api.gather(e2, lambda vals: float(
            sum(float(np.asarray(v)) for v in vals)), name="chtot")
        holder = {}

        def factory():
            holder["rts"] = _rts()
            return holder["rts"]

        res = api.run(total, resources=ResourceDescription(slots=4),
                      rts_factory=factory, chain=chain, timeout=60)
        states = dict(res.task_states)
        vals = [float(np.asarray(s.out.result())) for s in e2.specs]
        out = (states, vals, total.out.result(),
               dict(holder["rts"].fusion_stats))
        res.close()
        return out

    s_states, s_vals, s_total, _ = run(fuse=False, chain=False)
    c_states, c_vals, c_total, c_stats = run(fuse=True, chain=True)
    assert s_states == c_states
    assert all(v == st.DONE for v in c_states.values())
    assert s_vals == c_vals          # bit-identical member results
    assert s_total == c_total
    assert c_stats["chain_carriers"] > 0
    assert c_stats["chain_links"] == 3 * c_stats["chain_carriers"]
    assert c_stats["degraded"] == 0 and c_stats["scalar_fallback"] == 0


def test_chain_nonfinite_fails_member_and_downstream_links():
    e0 = api.ensemble(k_vector,
                      over=[{"x": float(i), "scale": 1.0,
                             "poison": float("nan") if i == 2 else 0.0}
                            for i in range(6)], name="pz0")
    e1 = e0.then(k_square, name="pz1", arg="x")
    res = api.run(e1, resources=ResourceDescription(slots=4),
                  rts_factory=_rts, timeout=60)
    states = res.task_states
    assert states["pz0-2"] == st.FAILED
    assert states["pz1-2"] == st.FAILED   # downstream of the poisoned link
    assert sum(v == st.DONE for v in states.values()) == 10
    assert "upstream chain member failed" in _task_named(
        res, "pz1-2").exception
    res.close()


def test_chain_exception_degrades_to_per_stage_then_scalar():
    e0 = api.ensemble(k_square,
                      over=[{"x": x, "scale": 1.0}
                            for x in (1.0, 10.0, 2.0, 3.0)], name="tc0")
    e1 = e0.then(k_touchy, name="tc1", arg="x")
    e2 = e1.then(k_square, name="tc2", arg="x")
    holder = {}

    def factory():
        holder["rts"] = _rts()
        return holder["rts"]

    res = api.run(e2, resources=ResourceDescription(slots=4),
                  rts_factory=factory, timeout=60)
    states = res.task_states
    # member 1: 10^2 = 100 -> k_touchy raises scalar too -> FAILED there,
    # and its tc2 link fails downstream; everyone else completes
    assert states["tc1-1"] == st.FAILED and states["tc2-1"] == st.FAILED
    assert sum(v == st.DONE for v in states.values()) == 10
    assert holder["rts"].fusion_stats["scalar_fallback"] >= 1
    assert holder["rts"].fusion_stats["degraded"] >= 1
    for i, x in enumerate((1.0, 10.0, 2.0, 3.0)):
        if i != 1:
            got = float(np.asarray(_task_named(res, f"tc2-{i}").result))
            assert got == (x * x + 1.0) ** 2
    res.close()


def test_chain_fail_stage_finalizes_once_and_never_hangs():
    e0 = api.ensemble(k_vector,
                      over=[{"x": float(i), "scale": 1.0,
                             "poison": float("nan") if i == 1 else 0.0}
                            for i in range(4)], name="fs0")
    e1 = e0.then(k_square, name="fs1")
    compiled = api.compile(e1, name="wf-fs")
    amgr = AppManager(resources=ResourceDescription(slots=4),
                      rts_factory=_rts, on_task_failure="fail_stage")
    amgr.workflow = compiled
    amgr.run(timeout=30)          # a hang would raise the timeout error
    assert amgr.wfp.component_errors == []
    states = {t.name: t.state for p in amgr.workflow
              for s in p.stages for t in s.tasks}
    assert states["fs0-1"] == st.FAILED
    assert states["fs0-0"] == st.DONE and states["fs1-0"] == st.DONE
    compiled.close()


def test_chain_upstream_retry_revives_downstream_links():
    attempts = {"n": 0}

    def injector(task):
        if task.name == "rt0-2":
            attempts["n"] += 1
            return attempts["n"] == 1   # first attempt only
        return False

    e0 = api.ensemble(k_square,
                      over=[{"x": float(i), "scale": 1.0} for i in range(6)],
                      name="rt0", max_retries=1)
    e1 = e0.then(k_square, name="rt1")   # downstream budget: zero retries
    res = api.run(e1, resources=ResourceDescription(slots=4),
                  rts_factory=lambda: _rts(fault_injector=injector),
                  timeout=60)
    assert attempts["n"] == 2            # exactly one retry
    assert all(v == st.DONE for v in res.task_states.values())
    for i, s in enumerate(e1.specs):
        assert float(np.asarray(s.out.result())) == float(i) ** 4
    res.close()


def test_running_since_and_cancel_for_undrained_async_carrier():
    rts = TorchRTS(device="cpu", slot_oversubscribe=2, fusion_min_batch=2)
    rts.start(ResourceDescription(slots=2))
    unplug = threading.Event()

    class _Plug:
        def drain(self, stop_event=None):
            unplug.wait(10)
            return {}

    try:
        # wedge every drainer behind a plug so the real carrier stays
        # dispatched but undrained
        for i in range(rts._n_drainers):
            rts._drain_q.put((Task(name=f"plug{i}", executable="plug://"),
                              type("B", (), {"members": []})(), _Plug()))
        members = [Task(name=f"ac{i}", executable=k_square,
                        kwargs={"x": float(i), "scale": 1.0},
                        tags={"_fusion_group": "AC"}) for i in range(3)]
        rts.submit(members)
        uids = {m.uid for m in members}
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if uids <= set(rts.running_since()):
                break
            time.sleep(0.01)
        assert uids <= set(rts.running_since())
        assert uids <= set(rts.in_flight())
        rts.cancel(list(uids))
        unplug.set()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with rts._pool_lock:
                leaked = bool(rts._leases)
            with rts._fusion_lock:
                tracked = bool(rts._fused)
            if not leaked and not tracked and rts.free_slots() == 2:
                break
            time.sleep(0.01)
        with rts._pool_lock:
            assert not rts._leases          # no leaked device lease
        assert rts.free_slots() == 2
        with rts._fusion_lock:
            assert not rts._fused and not rts._member_carrier
    finally:
        unplug.set()
        rts.stop()


# --------------------------------------------------------------------------- #
# Mid-chain resume (tests/test_api_resume.py)
# --------------------------------------------------------------------------- #

CL_CALLS = {0: 0, 1: 0, 2: 0, 3: 0}
CHAIN_GATE = threading.Event()


@fusable(static_argnames=("scale",))
def cl0(x, scale=1.0):
    CL_CALLS[0] += 1
    return _f32(x) * scale + 1.0


@fusable(static_argnames=("scale",))
def cl1(x, scale=1.0):
    CL_CALLS[1] += 1
    return _f32(x) * scale + 2.0


def _cl2_batched(x, scale=1.0):
    # hand-batched: runs eagerly at dispatch time, so session 1 blocks
    # HERE — after links 0-1 already streamed to the drainer and journaled
    CL_CALLS[2] += 1
    CHAIN_GATE.wait(30)
    return _f32(x) * scale + 3.0


@fusable(static_argnames=("scale",), batched=_cl2_batched)
def cl2(x, scale=1.0):
    CL_CALLS[2] += 1
    return _f32(x) * scale + 3.0


@fusable(static_argnames=("scale",))
def cl3(x, scale=1.0):
    CL_CALLS[3] += 1
    return _f32(x) * scale + 4.0


def _chain_workflow():
    e = api.ensemble(cl0, over=[{"x": float(i)} for i in range(4)],
                     name="l0")
    e = e.then(cl1, name="l1")
    e = e.then(cl2, name="l2")
    return e.then(cl3, name="l3")


def test_chain_resume_reenters_mid_chain_from_last_journaled_link(tmp_path):
    jp = str(tmp_path / "chain-resume.jsonl")

    # session 1: link 3's dispatch blocks; the run is killed by timeout.
    # slot_oversubscribe=1 -> one carrier, so every member's links 1-2 fan
    # out (and journal) before the blocked link wedges the chain
    CHAIN_GATE.clear()
    for k in CL_CALLS:
        CL_CALLS[k] = 0
    with pytest.raises(EnTKError, match="timed out"):
        api.run(_chain_workflow(), resources=ResourceDescription(slots=1),
                rts_factory=lambda: _rts(slots=1), name="cwf",
                journal_path=jp, timeout=3.0)
    replay = Journal.replay(jp)
    for i in range(4):
        assert replay["state"][("task", f"l0-{i}")] == st.DONE
        assert replay["state"][("task", f"l1-{i}")] == st.DONE
        assert replay["results"][f"l1-{i}"] == float(i) + 3.0
        assert replay["state"].get(("task", f"l2-{i}")) != st.DONE
        assert replay["state"].get(("task", f"l3-{i}")) != st.DONE

    # let the abandoned session-1 worker drain out before counting
    CHAIN_GATE.set()
    time.sleep(0.5)
    for k in CL_CALLS:
        CL_CALLS[k] = 0

    # session 2: resume; only links 3-4 may execute, re-entering the
    # chain mid-way (their entry inputs come from the journaled results)
    holder = {}

    def factory():
        holder["rts"] = _rts(slots=1)
        return holder["rts"]

    chain2 = _chain_workflow()
    res = api.run(chain2, resources=ResourceDescription(slots=1),
                  rts_factory=factory, name="cwf", journal_path=jp,
                  resume=True, timeout=60)
    assert res.all_done
    assert CL_CALLS[0] == 0 and CL_CALLS[1] == 0   # zero re-execution
    assert CL_CALLS[2] >= 1 and CL_CALLS[3] >= 1
    assert holder["rts"].fusion_stats["chain_carriers"] >= 1
    for i, s in enumerate(chain2.specs):
        assert float(np.asarray(s.out.result())) == float(i) + 10.0
    res.close()


CP_CALLS = {0: 0, 1: 0, 2: 0, 3: 0}


def _cp(level, bump):
    @fusable(static_argnames=("scale",))
    def kernel(x, poison=0.0, scale=1.0):
        CP_CALLS[level] += 1
        return _f32(x) * scale + bump + poison
    kernel.__name__ = kernel.__qualname__ = f"cp{level}"
    return kernel


cp0, cp1, cp2, cp3 = (_cp(i, float(i + 1)) for i in range(4))


def _poison_chain(poisoned):
    e = api.ensemble(cp0, over=[{"x": float(i)} for i in range(6)],
                     name="p0")
    e = e.then(cp1, over=[{"poison": float("nan") if i in poisoned else 0.0}
                          for i in range(6)], name="p1")
    e = e.then(cp2, name="p2")
    return e.then(cp3, name="p3")


def test_chain_resume_redispatches_only_failed_members_links(tmp_path):
    jp = str(tmp_path / "chain-poison.jsonl")

    # run 1: member 2 goes non-finite at link 2 (index 1)
    res = api.run(_poison_chain({2}), resources=ResourceDescription(slots=4),
                  rts_factory=_rts, name="pwf", journal_path=jp, timeout=60)
    states = res.task_states
    assert states["p0-2"] == st.DONE
    assert states["p1-2"] == st.FAILED
    assert states["p2-2"] == st.FAILED and states["p3-2"] == st.FAILED
    assert sum(v == st.DONE for v in states.values()) == 21  # 24 - 3
    res.close()

    # run 2 (resume, poison fixed): exactly the failed member's links 2-4
    # execute; every journaled DONE member restores without re-running
    for k in CP_CALLS:
        CP_CALLS[k] = 0
    holder = {}

    def factory():
        holder["rts"] = _rts()
        return holder["rts"]

    chain2 = _poison_chain(set())
    res2 = api.run(chain2, resources=ResourceDescription(slots=4),
                   rts_factory=factory, name="pwf", journal_path=jp,
                   resume=True, timeout=60)
    assert res2.all_done
    assert CP_CALLS[0] == 0                  # link 1 untouched
    assert all(CP_CALLS[k] >= 1 for k in (1, 2, 3))
    stats = holder["rts"].fusion_stats
    # exactly three member-links executed (member 2 at links 2-4)
    assert stats["fused"] + stats["scalar_fallback"] == 3
    for i, s in enumerate(chain2.specs):
        assert float(np.asarray(s.out.result())) == float(i) + 10.0
    res2.close()
