"""``run_misfit_ensemble`` on a mesh, against the JAX package's.

The single-kernel misfit sweep with its sum gather (``eval_misfit`` ->
``total_misfit``) on 8 lanes of the CPU, ``shard=True`` and
``shard=False``, held to ``JaxRTS`` on 8 forced host devices (one
subprocess for both of JAX's runs): misfits and total within 1e-4, the
same shard carrier counts, and the port's sharded misfits equal to its
unsharded ones. ``shard_min_members=8`` on both sides."""

import pytest

from _torch_sharded import run_jax
from repro_torch.apps.seismic.workflow import run_misfit_ensemble
from repro_torch.device import virtual_devices

SWEEP = dict(n_events=16, nx=32, nt=60, seed=0, dv=25.0, slots=4)

JAX_SOURCE = """
import json
import numpy as np
from repro import api
from repro.apps.seismic.workflow import build_misfit_ensemble, total_misfit
from repro.rts.base import ResourceDescription
from repro.rts.jax_rts import JaxRTS

SWEEP = __SWEEP__
out = {}
for shard in (True, False):
    ens = build_misfit_ensemble(SWEEP["n_events"], nx=SWEEP["nx"],
                                nz=SWEEP["nx"], nt=SWEEP["nt"],
                                seed=SWEEP["seed"], dv=SWEEP["dv"])
    obj = api.gather(ens, total_misfit, name="total-misfit-0")
    holder = {}
    def factory():
        holder["rts"] = JaxRTS(slot_oversubscribe=SWEEP["slots"],
                               shard=shard, shard_min_members=8)
        return holder["rts"]
    res = api.run(obj, resources=ResourceDescription(slots=SWEEP["slots"]),
                  rts_factory=factory, shard=shard, timeout=240)
    out[str(shard)] = {
        "all_done": bool(res.all_done),
        "total": float(np.asarray(obj.out.result())),
        "misfits": [float(np.asarray(s.out.result())) for s in ens.specs],
        "stats": dict(holder["rts"].fusion_stats)}
    res.close()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_out():
    return run_jax(JAX_SOURCE.replace("__SWEEP__", repr(SWEEP)))


@pytest.fixture(scope="module")
def port_out():
    kw = {k: v for k, v in SWEEP.items() if k not in ("n_events", "slots")}
    return {shard: run_misfit_ensemble(
                SWEEP["n_events"], SWEEP["slots"], device="cpu",
                places=virtual_devices("cpu", 8), shard=shard,
                shard_min_members=8, **kw)
            for shard in (True, False)}


@pytest.mark.parametrize("shard", [True, False])
def test_misfit_ensemble_on_a_mesh_matches_jax(jax_out, port_out, shard):
    got, want = port_out[shard], jax_out[str(shard)]
    assert got["all_done"] and want["all_done"]
    stats = got["fusion_stats"]
    assert stats["shard_carriers"] == want["stats"]["shard_carriers"]
    assert stats["shard_carriers"] == (1 if shard else 0)
    assert stats["sharded_dispatches"] == \
        want["stats"]["sharded_dispatches"]
    assert stats["degraded"] == stats["scalar_fallback"] == 0
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(got["misfits"], want["misfits"]))
    assert rel <= 1e-4
    assert abs(got["total_misfit"] - want["total"]) <= \
        1e-4 * abs(want["total"])


def test_sharded_misfit_ensemble_equals_unsharded(port_out):
    """Members bit-equal; the sum within 1e-4 relative (the places'
    partials are added in place order)."""
    got, ref = port_out[True], port_out[False]
    assert got["fusion_stats"]["dag_carriers"] == 1
    assert got["misfits"] == ref["misfits"]
    assert abs(got["total_misfit"] - ref["total_misfit"]) <= \
        1e-4 * abs(ref["total_misfit"])
