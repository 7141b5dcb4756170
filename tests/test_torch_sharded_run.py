"""The port's sharded tier run end to end on 8 lanes of the CPU against
the JAX package's on 8 forced host devices (one subprocess,
``tests/test_shard.py``'s descriptions): the same values, the same shard
carriers, the planner's dispatch bound, a journaled plan on every member
and a resume that reruns only the failures. Also: each shard gets its own
place's rows and ``device`` argument, a failed sharded dispatch degrades
and loses nothing, and AnEn on the sharded tier gives the unsharded run's
values."""

import json

import numpy as np
import pytest
import torch

from _torch_sharded import run_jax
from repro_torch import api
from repro_torch.core import states as st
from repro_torch.device import virtual_devices
from repro_torch.fusion import engine as fengine
from repro_torch.fusion import fusable
from repro_torch.fusion.handles import ShardedValue
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

N, BAD = 128, {3, 77}

JAX_SOURCE = """
import json
import numpy as np
from repro import api
from repro.fusion import fusable
from repro.rts.base import ResourceDescription
from repro.rts.jax_rts import JaxRTS

@fusable(static_argnames=("scale",))
def kern(x, scale=1.0):
    import jax.numpy as jnp
    x = jnp.asarray(x, jnp.float32)
    return x * x * scale

CALLS = [0]

@fusable()
def kern_sum(xs, poison=0.0):
    CALLS[0] += 1
    import jax.numpy as jnp
    return jnp.asarray(xs, jnp.float32).sum() + poison

out = {}
holder = {}
def factory():
    holder["rts"] = JaxRTS(slot_oversubscribe=16, fusion_max_batch=16)
    return holder["rts"]
over = [{"x": float(i % 97), "scale": 2.0} for i in range(512)]
ens = api.ensemble(kern, over=over, name="e")
res = api.run(ens, resources=ResourceDescription(slots=16),
              rts_factory=factory, timeout=240)
out["values"] = [float(np.asarray(s.out.result())) for s in ens.specs]
out["stats"] = dict(holder["rts"].fusion_stats)
out["all_done"] = bool(res.all_done)
res.close()

N, BAD = __N__, __BAD__
journal = __JOURNAL__
def build(poisoned):
    return api.ensemble(
        kern_sum, over=[{"xs": [float(i)] * 3,
                         "poison": float("nan") if i in poisoned else 0.0}
                        for i in range(N)], name="pr")
res = api.run(build(BAD), resources=ResourceDescription(slots=16),
              rts_factory=factory, journal_path=journal, timeout=240)
states = dict(res.task_states)
out["resume_first"] = {"stats": dict(holder["rts"].fusion_stats)}
res.close()
CALLS[0] = 0
ens2 = build(set())
res2 = api.run(ens2, resources=ResourceDescription(slots=16),
               rts_factory=factory, journal_path=journal, resume=True,
               timeout=240)
out["resume"] = {
    "failed_first": sorted(int(k[3:]) for k, v in states.items()
                           if v == "FAILED"),
    "done_first": sum(v == "DONE" for v in states.values()),
    "resume_all_done": bool(res2.all_done), "resume_calls": CALLS[0],
    "resume_sharded": holder["rts"].fusion_stats["sharded_dispatches"],
    "values": [float(np.asarray(s.out.result())) for s in ens2.specs]}
res2.close()
print(json.dumps(out))
"""


@fusable(static_argnames=("scale",))
def kern(x, scale=1.0):
    x = torch.as_tensor(x, dtype=torch.float32)
    return x * x * scale


CALLS = [0]


@fusable()
def kern_sum(xs, poison=0.0):
    CALLS[0] += 1
    return torch.as_tensor(xs, dtype=torch.float32).sum() + poison


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    journal = str(tmp_path_factory.mktemp("jax") / "journal.jsonl")
    return run_jax(JAX_SOURCE.replace("__N__", str(N))
                   .replace("__BAD__", repr(BAD))
                   .replace("__JOURNAL__", repr(journal)))


def _factory(holder, **kw):
    def factory():
        holder["rts"] = TorchRTS(devices=virtual_devices("cpu", 8),
                                 slot_oversubscribe=16, fusion_max_batch=16,
                                 **kw)
        return holder["rts"]
    return factory


def _run(shard):
    holder = {}
    over = [{"x": float(i % 97), "scale": 2.0} for i in range(512)]
    ens = api.ensemble(kern, over=over, name="e", fuse=shard)
    res = api.run(ens, resources=ResourceDescription(slots=16),
                  rts_factory=_factory(holder, shard=shard), shard=shard,
                  timeout=240)
    vals = [float(np.asarray(s.out.result())) for s in ens.specs]
    stats = dict(holder["rts"].fusion_stats)
    done = res.all_done
    res.close()
    return vals, stats, done


@pytest.fixture(scope="module")
def port_runs():
    return _run(shard=True), _run(shard=False)


def test_sharded_values_match_jax(jax_out, port_runs):
    (vals, _, done), _ = port_runs
    assert done and jax_out["all_done"]
    drift = max(abs(a - b) / max(abs(b), 1e-12)
                for a, b in zip(vals, jax_out["values"]))
    assert drift <= 1e-4


def test_sharded_values_equal_unsharded(port_runs):
    (vals, _, _), (s_vals, s_stats, s_done) = port_runs
    assert s_done and vals == s_vals
    assert s_stats["sharded_dispatches"] == s_stats["shard_carriers"] == 0


def test_sharded_counters_match_jax(jax_out, port_runs):
    (_, stats, _), _ = port_runs
    bound = -(-512 // (8 * 16))    # ceil(N / (places x max_batch))
    assert 1 <= stats["sharded_dispatches"] <= bound
    assert stats["shard_carriers"] == jax_out["stats"]["shard_carriers"]
    assert stats["sharded_dispatches"] == \
        jax_out["stats"]["sharded_dispatches"]
    assert stats["fused"] == jax_out["stats"]["fused"] == 512
    assert stats["degraded"] == stats["scalar_fallback"] == 0


def test_sharded_journal_plan_and_resume_reruns_only_failures(
        jax_out, tmp_path):
    journal = str(tmp_path / "journal.jsonl")
    holder = {}

    def build(poisoned):
        return api.ensemble(
            kern_sum, over=[{"xs": [float(i)] * 3,
                             "poison": float("nan") if i in poisoned
                             else 0.0} for i in range(N)], name="pr")

    res = api.run(build(BAD), resources=ResourceDescription(slots=16),
                  rts_factory=_factory(holder), journal_path=journal,
                  timeout=240)
    states = dict(res.task_states)
    first_stats = dict(holder["rts"].fusion_stats)
    res.close()
    plans = [rec["plan"] for rec in map(json.loads, open(journal))
             if rec.get("to") == "DONE" and rec.get("plan")]
    CALLS[0] = 0
    ens2 = build(set())
    res2 = api.run(ens2, resources=ResourceDescription(slots=16),
                   rts_factory=_factory(holder), journal_path=journal,
                   resume=True, timeout=240)
    got = {
        "failed_first": sorted(int(k[3:]) for k, v in states.items()
                               if v == "FAILED"),
        "done_first": sum(v == "DONE" for v in states.values()),
        "resume_all_done": bool(res2.all_done), "resume_calls": CALLS[0],
        "resume_sharded": holder["rts"].fusion_stats["sharded_dispatches"],
        "values": [float(np.asarray(s.out.result())) for s in ens2.specs]}
    res2.close()
    assert got == jax_out["resume"]
    assert got["failed_first"] == sorted(BAD) and got["resume_calls"] == 2
    assert len(plans) == N - len(BAD)
    assert all(p["kind"] == "shard" for p in plans)
    assert first_stats["shard_carriers"] == \
        jax_out["resume_first"]["stats"]["shard_carriers"]
    assert first_stats["failed"] == len(BAD)


SEEN = []


def _recording_batched(x, *, device):
    SEEN.append((device, x.device, x.detach().clone()))
    return x * 3.0


@fusable(static_argnames=("device",), batched=_recording_batched)
def k_record(x, device="cpu"):
    return torch.as_tensor(x, dtype=torch.float32) * 3.0


def test_each_shard_gets_its_place_device_and_rows():
    """A recording hand-batched kernel sees one call per place, in place
    order, each with the place's device as its ``device`` argument (the
    static said ``cuda:3``; the places are lanes of the CPU) and exactly
    that place's rows of the member axis."""
    SEEN.clear()
    places = virtual_devices("cpu", 4)
    ens = api.ensemble(k_record, over=[{"x": float(i), "device": "cuda:3"}
                                       for i in range(64)], name="rec")
    holder = {}

    def factory():
        holder["rts"] = TorchRTS(devices=places, slot_oversubscribe=1)
        return holder["rts"]

    res = api.run(ens, resources=ResourceDescription(slots=4),
                  rts_factory=factory, timeout=120)
    assert res.all_done
    vals = [float(np.asarray(s.out.result())) for s in ens.specs]
    stats = dict(holder["rts"].fusion_stats)
    res.close()
    assert vals == [3.0 * i for i in range(64)]
    assert stats["shard_carriers"] == 1 and stats["sharded_dispatches"] == 1
    assert [d for d, _, _ in SEEN] == ["cpu"] * 4
    assert all(dev == torch.device("cpu") for _, dev, _ in SEEN)
    for i, (_, _, rows) in enumerate(SEEN):
        assert rows.tolist() == [float(r) for r in range(16 * i, 16 * i + 16)]


def test_place_statics():
    assert fengine._place_statics({"device": "cuda:0", "k": 3},
                                  torch.device("cuda", 1)) == \
        {"device": "cuda:1", "k": 3}
    same = {"k": 3}
    assert fengine._place_statics(same, torch.device("cuda", 1)) is same


def test_sharded_dispatch_failure_degrades_not_fails(monkeypatch):
    """An exception inside the sharded dispatch (here: placement) fails no
    member: the carrier degrades through the ladder, per-stage fused on
    one device, counted in ``degraded``."""
    def boom(self):
        raise RuntimeError("injected placement failure")
    monkeypatch.setattr(fengine.ChainExecution, "_place_plans", boom)
    holder = {}
    ens = api.ensemble(kern, over=[{"x": float(i)} for i in range(64)],
                       name="dg")
    res = api.run(ens, resources=ResourceDescription(slots=16),
                  rts_factory=_factory(holder), timeout=120)
    assert all(v == st.DONE for v in res.task_states.values())
    vals = [float(np.asarray(s.out.result())) for s in ens.specs]
    stats = dict(holder["rts"].fusion_stats)
    res.close()
    assert vals == [float(i * i) for i in range(64)]
    assert stats["sharded_dispatches"] == 0 and stats["degraded"] >= 1
    assert stats["shard_carriers"] >= 1


def test_chain_on_the_sharded_tier_keeps_intermediates_on_places():
    """A 2-link chain over 4 lanes: both links run on each lane's shard,
    the carried intermediate a sharded value between them."""
    @fusable()
    def c_one(x):
        return torch.as_tensor(x, dtype=torch.float32) + 1.0

    @fusable()
    def c_two(y):
        return y * 2.0

    seen = []
    real = fengine._sharded_segment

    def spy(mesh, plans, carry):
        outs = real(mesh, plans, carry)
        seen.append([type(o) for o in outs])
        return outs

    ens = api.ensemble(c_one, over=[{"x": float(i)} for i in range(64)],
                       name="c1")
    two = ens.then(c_two, name="c2")
    holder = {}

    def factory():
        holder["rts"] = TorchRTS(devices=virtual_devices("cpu", 4),
                                 slot_oversubscribe=1)
        return holder["rts"]

    fengine._sharded_segment = spy
    try:
        res = api.run(two, resources=ResourceDescription(slots=4),
                      rts_factory=factory, timeout=120)
    finally:
        fengine._sharded_segment = real
    assert res.all_done
    vals = [float(np.asarray(s.out.result())) for s in two.specs]
    stats = dict(holder["rts"].fusion_stats)
    res.close()
    assert vals == [2.0 * (i + 1.0) for i in range(64)]
    assert stats["chain_carriers"] == stats["shard_carriers"] == 1
    assert stats["chain_links"] == 2
    assert seen == [[ShardedValue, ShardedValue]]


def test_anen_sharded_equals_unsharded():
    from repro_torch.apps.anen.workflow import run_random
    kw = dict(device="cpu", seed=3, ny=20, nx=20, n_hist=30, per_iter=128,
              max_iters=2, n_tasks=16, slots=4)
    got = run_random(places=virtual_devices("cpu", 4), shard_min_members=16,
                     **kw)
    ref = run_random(places=virtual_devices("cpu", 4), shard=False, **kw)
    assert got["all_done"] and ref["all_done"]
    assert got["fusion_stats"]["shard_carriers"] == 2
    assert got["fusion_stats"]["sharded_dispatches"] == 4
    assert ref["fusion_stats"]["shard_carriers"] == 0
    assert got["values"] == ref["values"] and got["errors"] == ref["errors"]


def test_a_collapsed_lease_runs_on_one_device():
    """Two lanes, two logical slots each: a 2-place shard carrier whose
    lease comes back as one lane twice (the slots left in the pool both
    map to lane 1) runs unsharded on the lane's device, and every member
    completes."""
    import threading
    import time

    from repro_torch.core.pst import Task
    from repro_torch.rts.torch_rts import CARRIERS_TOTAL

    rts = TorchRTS(devices=virtual_devices("cpu", 2), slot_oversubscribe=2,
                   shard_min_members=8)
    done = []
    rts.set_callback(done.append)
    rts.start(ResourceDescription(slots=4))
    try:
        members = [Task(name=f"c{i}", executable=kern,
                        kwargs={"x": float(i)}) for i in range(16)]
        out = []
        rts._pack_group(members, out, rts.free_slots())
        assert len(out) == 1 and out[0].name.startswith("shard[2x1x16]")
        carrier = out[0]
        with rts._pool_lock:
            rts._pool = [1, 3]
        with rts._work:
            rts._slots_free -= carrier.slots
        rts._run_fused(carrier, rts._fused[carrier.uid], threading.Event())
        deadline = time.time() + 30
        while len(done) < 16 and time.time() < deadline:
            time.sleep(0.01)
        assert sorted(c.exit_code for c in done) == [0] * 16
        assert sorted(float(np.asarray(c.result)) for c in done) == \
            [float(i * i) for i in range(16)]
        stats = rts.fusion_stats
        assert stats["shard_carriers"] == 1
        assert stats["sharded_dispatches"] == 0 and stats["fused"] == 16
        tiers = {labels["tier"]: c.value for labels, c in
                 rts.metrics.collect("counter", CARRIERS_TOTAL)}
        assert tiers == {"fused": 1}
    finally:
        rts.stop()
