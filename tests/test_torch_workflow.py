"""The port's adaptive AnEn workflow against the JAX package's, on the CPU.

Same settings as the JAX package's fused-vs-scalar check
(``tests/test_fusion.py::test_anen_fused_matches_scalar``): both packages
draw the same locations (numpy randomness), so the per-round errors agree
to float32 rounding. The JAX run composes each round as one DAG dispatch;
the port fuses per stage (``chain=False``) — ``analog_refine`` is the
identity on these inputs and ``round_spread`` a plain max, so the values
are the same.
"""

import threading

import numpy as np
import pytest

from repro.apps.anen import workflow as jwf
from repro_torch.apps.anen import workflow as twf
from repro_torch.core.pst import Task
from repro_torch.fusion.groups import CHAIN_TAG, DAG_TAG
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

KW = dict(ny=20, nx=20, n_hist=30, per_iter=16, max_iters=2,
          n_tasks=4, slots=4, timeout=120)


@pytest.mark.parametrize("method", ["run_adaptive", "run_random"])
def test_port_matches_jax_errors(method):
    ref = getattr(jwf, method)(seed=3, **KW)
    got = getattr(twf, method)(seed=3, device="cpu", **KW)
    assert ref["all_done"] and got["all_done"]
    assert got["rounds"] == ref["rounds"] == KW["max_iters"]
    assert got["n_locations"] == ref["n_locations"]
    assert np.allclose(got["errors"], ref["errors"], rtol=0, atol=1e-5)


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


@pytest.mark.parametrize("tag,tier", [(CHAIN_TAG, "chain"), (DAG_TAG, "DAG")])
def test_unported_tier_task_fails_with_exit_code_2(tag, tier):
    rts = TorchRTS(device="cpu")
    done = []
    got = threading.Event()
    rts.set_callback(lambda c: (done.append(c), got.set()))
    rts.start(ResourceDescription(slots=1))
    try:
        task = Task(name="link", executable="sleep://0",
                    tags={tag: "c0:0:0"})
        rts.submit([task])
        assert got.wait(5)
    finally:
        rts.stop()
    (c,) = done
    assert c.uid == task.uid and c.exit_code == 2
    assert tier in c.exception and tag in c.exception
    assert not rts.supports_chain_fusion() and not rts.supports_dag_fusion()
