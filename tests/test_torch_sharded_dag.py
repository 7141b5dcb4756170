"""The sharded DAG against the JAX package's. The seismic sweep (forward
-> misfit -> sum) at the card check's small size, ``shard_min_members=8``
on both sides, runs as one ``dag-shard`` carrier on 8 lanes of the CPU and
on ``JaxRTS`` over 8 forced host devices (one subprocess, which also runs
JAX's unsharded DAG: the JAX package has no test of its sharded DAG, so
this holds it to its own unsharded run). Then every reduction kind over a
poisoned member: count, min and max exactly equal to the unsharded run,
sums and means within 1e-4 relative; and a custom combine refuses the
mesh."""

import numpy as np
import pytest
import torch

from _torch_sharded import run_jax
from repro_torch import api
from repro_torch.apps.seismic.workflow import run_misfit_chain
from repro_torch.core.pst import Task
from repro_torch.device import virtual_devices
from repro_torch.fusion import engine as fengine
from repro_torch.fusion import fusable, fusable_reduction
from repro_torch.fusion.handles import to_host
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

SWEEP = dict(n_events=8, nx=32, nt=60, seed=0, dv=25.0, slots=4)
KINDS = ("sum", "mean", "min", "max")
WIDTH, POISON = 32, 5

JAX_SOURCE = """
import json
import numpy as np
from repro import api
from repro.apps.seismic.workflow import build_misfit_chain, total_misfit
from repro.fusion import fusable, fusable_reduction
from repro.rts.base import ResourceDescription
from repro.rts.jax_rts import JaxRTS

SWEEP = __SWEEP__
KINDS, WIDTH, POISON = __KINDS__, __WIDTH__, __POISON__

def run(objective, members, slots, shard, oversubscribe):
    holder = {}
    def factory():
        holder["rts"] = JaxRTS(slot_oversubscribe=oversubscribe,
                               shard=shard, shard_min_members=8)
        return holder["rts"]
    res = api.run(objective, resources=ResourceDescription(slots=slots),
                  rts_factory=factory, shard=shard, timeout=240)
    out = {"all_done": bool(res.all_done),
           "states": sorted(set(res.task_states.values())),
           "value": np.asarray(objective.out.result()).tolist(),
           "members": [np.asarray(s.out.result()).tolist()
                       if res.task_states[s.name] == "DONE" else None
                       for s in members.specs],
           "stats": dict(holder["rts"].fusion_stats)}
    res.close()
    return out

out = {"seismic": {}, "kinds": {}}
for shard in (True, False):
    ens = build_misfit_chain(SWEEP["n_events"], nx=SWEEP["nx"],
                             nz=SWEEP["nx"], nt=SWEEP["nt"],
                             seed=SWEEP["seed"], dv=SWEEP["dv"])
    obj = api.gather(ens, total_misfit, name="total-chain-0")
    out["seismic"][str(shard)] = run(obj, ens, SWEEP["slots"], shard,
                                     SWEEP["slots"])

@fusable()
def k_vec(x, poison=0.0):
    import jax.numpy as jnp
    x = jnp.asarray(x, jnp.float32)
    return jnp.stack([x, -x, x * x + 0.1]) + poison

for kind in KINDS:
    @fusable_reduction(kind=kind)
    def red(values):
        raise RuntimeError("the scalar body must not run")
    ens = api.ensemble(k_vec, over=[
        {"x": float(i) * 0.37 - 3.0,
         "poison": float("nan") if i == POISON else 0.0}
        for i in range(WIDTH)], name=f"v-{kind}")
    obj = api.gather(ens, red, name=f"r-{kind}")
    out["kinds"][kind] = run(obj, ens, 8, True, 1)
print(json.dumps(out))
"""


def _jax_source():
    return (JAX_SOURCE.replace("__SWEEP__", repr(SWEEP))
            .replace("__KINDS__", repr(KINDS))
            .replace("__WIDTH__", str(WIDTH))
            .replace("__POISON__", str(POISON)))


@pytest.fixture(scope="module")
def jax_out():
    return run_jax(_jax_source())


def _seismic(shard):
    kw = {k: v for k, v in SWEEP.items() if k not in ("n_events", "slots")}
    return run_misfit_chain(SWEEP["n_events"], SWEEP["slots"], device="cpu",
                            places=virtual_devices("cpu", 8), shard=shard,
                            shard_min_members=8, **kw)


@pytest.fixture(scope="module")
def seismic_runs():
    return _seismic(True), _seismic(False)


def test_seismic_sharded_dag_matches_jax(jax_out, seismic_runs):
    got, _ = seismic_runs
    want = jax_out["seismic"]["True"]
    assert got["all_done"] and want["all_done"]
    stats = got["fusion_stats"]
    assert stats["dag_carriers"] == 1 and stats["shard_carriers"] == 1
    assert stats["shard_carriers"] == want["stats"]["shard_carriers"]
    assert stats["sharded_dispatches"] == want["stats"]["sharded_dispatches"]
    assert stats["degraded"] == stats["scalar_fallback"] == 0
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(got["misfits"], want["members"]))
    assert rel <= 1e-4
    assert abs(got["total_misfit"] - want["value"]) <= \
        1e-4 * abs(want["value"])


def test_seismic_sharded_dag_equals_unsharded(seismic_runs):
    """Per-member misfits bit-equal; the sum within 1e-4 relative (the
    places' partial sums are added in place order)."""
    got, ref = seismic_runs
    assert ref["all_done"] and ref["fusion_stats"]["shard_carriers"] == 0
    assert got["misfits"] == ref["misfits"]
    assert abs(got["total_misfit"] - ref["total_misfit"]) <= \
        1e-4 * abs(ref["total_misfit"])
    assert abs(got["total_misfit"] - sum(got["misfits"])) <= \
        1e-4 * abs(got["total_misfit"])


def test_jax_sharded_dag_equals_jax_unsharded(jax_out):
    sharded, plain = jax_out["seismic"]["True"], jax_out["seismic"]["False"]
    assert sharded["all_done"] and plain["all_done"]
    assert sharded["stats"]["shard_carriers"] == 1
    assert plain["stats"]["shard_carriers"] == 0
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(sharded["members"], plain["members"]))
    assert rel <= 1e-4
    assert abs(sharded["value"] - plain["value"]) <= \
        1e-4 * abs(plain["value"])


@fusable()
def k_vec(x, poison=0.0):
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.stack([x, -x, x * x + 0.1]) + poison


@fusable()
def k_int(x):
    x = torch.as_tensor(x, dtype=torch.int32)
    return torch.stack([x, x * 7 - 40])


def _reducer(kind):
    @fusable_reduction(kind=kind)
    def red(values):
        raise RuntimeError("the scalar body must not run")
    return red


def _run_kind(kernel, kind, shard, poison=True):
    over = [{"x": float(i) * 0.37 - 3.0} for i in range(WIDTH)] \
        if kernel is k_vec else [{"x": i - 9} for i in range(WIDTH)]
    if poison:
        for i, o in enumerate(over):
            o["poison"] = float("nan") if i == POISON else 0.0
    ens = api.ensemble(kernel, over=over, name=f"v-{kind}")
    obj = api.gather(ens, _reducer(kind), name=f"r-{kind}")
    holder = {}

    def factory():
        holder["rts"] = TorchRTS(devices=virtual_devices("cpu", 8),
                                 shard=shard, shard_min_members=8)
        return holder["rts"]

    res = api.run(obj, resources=ResourceDescription(slots=8),
                  rts_factory=factory, shard=shard, timeout=120)
    out = {"value": np.asarray(obj.out.result()),
           "states": sorted(set(res.task_states.values())),
           "failed": [i for i, s in enumerate(ens.specs)
                      if res.task_states[s.name] == "FAILED"],
           "stats": dict(holder["rts"].fusion_stats)}
    res.close()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_reduction_kinds(jax_out, kind):
    got = _run_kind(k_vec, kind, True)
    ref = _run_kind(k_vec, kind, False)
    want = jax_out["kinds"][kind]
    assert got["stats"]["shard_carriers"] == 1 == \
        want["stats"]["shard_carriers"]
    assert got["stats"]["sharded_dispatches"] == \
        want["stats"]["sharded_dispatches"]
    assert ref["stats"]["shard_carriers"] == 0
    assert got["failed"] == ref["failed"] == [POISON]
    assert got["states"] == ref["states"] == ["DONE", "FAILED"]
    if kind in ("min", "max"):
        assert got["value"] == ref["value"]
    else:
        assert abs(got["value"] - ref["value"]) <= 1e-4 * abs(ref["value"])
    assert abs(got["value"] - want["value"]) <= 1e-4 * abs(want["value"])


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_reduction_integer_leaves_exact(kind):
    got = _run_kind(k_int, kind, True, poison=False)
    ref = _run_kind(k_int, kind, False, poison=False)
    assert got["stats"]["shard_carriers"] == 1
    assert got["states"] == ["DONE"]
    assert got["value"] == ref["value"]


def test_custom_combine_refuses_the_mesh():
    """A reduction with its own combine sees only its shard under a mesh:
    the RTS plans no mesh for it, and an engine handed one anyway refuses
    composition and runs the nodes in order on one device."""
    def combine(stacked, valid):
        return torch.where(valid[:, None], stacked, 0).sum()

    @fusable_reduction(combine=combine)
    def red(values):
        return float(np.sum([np.sum(to_host(v)) for v in values]))

    ens = api.ensemble(k_vec, over=[{"x": float(i)} for i in range(WIDTH)],
                       name="cc")
    obj = api.gather(ens, red, name="cc-r")
    holder = {}

    def factory():
        holder["rts"] = TorchRTS(devices=virtual_devices("cpu", 8),
                                 shard_min_members=8)
        return holder["rts"]

    res = api.run(obj, resources=ResourceDescription(slots=8),
                  rts_factory=factory, timeout=120)
    value = obj.out.result()
    stats = dict(holder["rts"].fusion_stats)
    res.close()
    assert res.all_done and stats["shard_carriers"] == 0
    want = sum(float(i) - float(i) + float(i) * i + 0.1 for i in range(WIDTH))
    assert abs(value - want) <= 1e-4 * abs(want)

    # the engine's own refusal
    links = [[Task(name=f"m{i}", executable=k_vec, kwargs={"x": 1.0},
                   tags={"_fusion_dag": {"c": "d", "k": 0, "m": i,
                                         "n": 2, "w": 8}})
              for i in range(8)],
             [Task(name="r", executable=red, kwargs={},
                   tags={"_fusion_dag": {"c": "d", "k": 1, "m": 0, "n": 2,
                                         "w": 1, "r": "r"}})]]
    exe = fengine.DagExecution(links, virtual_devices("cpu", 8),
                               __import__("threading").Event(),
                               lambda c: None,
                               mesh_devices=virtual_devices("cpu", 8))
    assert exe.tier == "dag-shard"
    with pytest.raises(fengine.Incongruent, match="custom combine"):
        exe._prepare_nodes()
