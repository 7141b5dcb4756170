"""The port's adaptive AnEn workflow against the JAX package's, on the CPU.

Same settings as the JAX package's fused-vs-scalar check
(``tests/test_fusion.py::test_anen_fused_matches_scalar``): both packages
draw the same locations (numpy randomness), so the per-round errors agree
to float32 rounding. Both compile each round to the same fusable DAG
(``analog_values → analog_refine → max``) and run it as one DAG carrier,
so their DAG counters agree too.
"""

import numpy as np
import pytest

from repro.apps.anen import workflow as jwf
from repro.rts.jax_rts import JaxRTS
from repro_torch import api
from repro_torch.apps.anen import workflow as twf
from repro_torch.core import states as st
from repro_torch.fusion import fusable, fusable_reduction
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

KW = dict(ny=20, nx=20, n_hist=30, per_iter=16, max_iters=2,
          n_tasks=4, slots=4, timeout=120)


DAG_KEYS = ("dag_carriers", "dag_links", "dispatches")


@pytest.mark.parametrize("method", ["run_adaptive", "run_random"])
def test_port_matches_jax_errors(method, monkeypatch):
    # the JAX run builds its RTS inside the workflow: record it on the way
    # out to read its counters
    made = []

    def recording_rts(**kw):
        made.append(JaxRTS(**kw))
        return made[-1]

    monkeypatch.setattr(jwf, "JaxRTS", recording_rts)
    ref = getattr(jwf, method)(seed=3, **KW)
    got = getattr(twf, method)(seed=3, device="cpu", **KW)
    assert ref["all_done"] and got["all_done"]
    assert got["rounds"] == ref["rounds"] == KW["max_iters"]
    assert got["n_locations"] == ref["n_locations"]
    assert np.allclose(got["errors"], ref["errors"], rtol=0, atol=1e-5)
    ref_stats = {k: sum(r.fusion_stats[k] for r in made) for k in DAG_KEYS}
    stats = got["fusion_stats"]
    assert {k: stats[k] for k in DAG_KEYS} == ref_stats
    # one DAG carrier a round, each round's three nodes fanned out
    assert stats["dag_carriers"] == KW["max_iters"]
    assert stats["dag_links"] == 3 * KW["max_iters"]
    assert stats["scalar_fallback"] == 0 and stats["degraded"] == 0


def test_port_fused_matches_port_scalar_and_fuses():
    fused = twf.run_adaptive(seed=3, device="cpu", **KW)
    scalar = twf.run_adaptive(seed=3, device="cpu", fuse=False, **KW)
    assert fused["all_done"] and scalar["all_done"]
    assert np.allclose(fused["errors"], scalar["errors"], rtol=0, atol=1e-5)
    stats = fused["fusion_stats"]
    # both stages of both rounds went through fused dispatches, none
    # degraded or fell back to scalar
    assert stats["fused"] > 0 and stats["dispatches"] >= 2 * KW["max_iters"]
    assert stats["scalar_fallback"] == 0 and stats["degraded"] == 0
    assert scalar["fusion_stats"]["fused"] == 0


@fusable(static_argnames=("scale",))
def _k_scale(x, scale=1.0):
    import torch
    return torch.as_tensor(x, dtype=torch.float32) * scale


@fusable_reduction(kind="sum")
def _k_total(values):
    return float(np.sum([np.asarray(v) for v in values]))


def _chain_shaped():
    e0 = api.ensemble(_k_scale, over=[{"x": float(i), "scale": 2.0}
                                      for i in range(4)], name="tk0")
    return e0.then(_k_scale, name="tk1"), "chain_carriers", 2.0 * 6


def _dag_shaped():
    e0 = api.ensemble(_k_scale, over=[{"x": float(i), "scale": 2.0}
                                      for i in range(4)], name="td0")
    return api.gather(e0, _k_total, name="tdr"), "dag_carriers", 2.0 * 6


@pytest.mark.parametrize("shape", [_chain_shaped, _dag_shaped],
                         ids=["chain", "DAG"])
def test_chain_and_dag_tagged_tasks_run_on_torch_rts(shape):
    """Chain- and DAG-shaped workflows compiled at the API's defaults run
    on TorchRTS through their tier: every task DONE, none refused with
    exit code 2."""
    node, carriers, want = shape()
    rts_box = []

    def factory():
        rts_box.append(TorchRTS(device="cpu", slot_oversubscribe=4))
        return rts_box[-1]

    res = api.run(node, resources=ResourceDescription(slots=4),
                  rts_factory=factory, timeout=60)
    (rts,) = rts_box
    assert rts.supports_chain_fusion() and rts.supports_dag_fusion()
    assert res.all_done
    assert all(v == st.DONE for v in res.task_states.values())
    assert rts.fusion_stats[carriers] >= 1
    assert rts.fusion_stats["degraded"] == 0
    if carriers == "chain_carriers":
        got = sum(float(np.asarray(s.out.result())) for s in node.specs)
    else:
        got = float(np.asarray(node.out.result()))
    assert got == want
    res.close()
