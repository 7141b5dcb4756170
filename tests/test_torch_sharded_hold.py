"""The sharded tier's hold buffer against the JAX package's: the cases of
``tests/test_shard.py`` (full-mesh quanta, the bypass when no mesh can
fire, the idle timer's re-arm and flush, cancellation, the whole-mesh slot
charge) run on ``JaxRTS`` over 8 forced host devices in a subprocess and
on ``TorchRTS(devices=virtual_devices("cpu", 8))`` here, and must see the
same carriers, holds and counters."""

import pytest

from _torch_sharded import SCENARIOS, run_jax
from repro_torch.core.pst import Task
from repro_torch.device import virtual_devices
from repro_torch.fusion import fusable
from repro_torch.rts.torch_rts import TorchRTS

JAX_SOURCE = """
import json
import jax
from _torch_sharded import SCENARIOS
from repro.core.pst import Task
from repro.fusion import fusable
from repro.rts.jax_rts import JaxRTS

@fusable()
def k_hold(x):
    import jax.numpy as jnp
    return jnp.asarray(x, jnp.float32) * 2.0

def make_rts():
    return JaxRTS(devices=jax.devices(), fusion_max_batch=8,
                  shard_min_members=8, shard_hold_s=30.0)

assert len(jax.devices()) == 8
print(json.dumps({name: fn(make_rts, Task, k_hold)
                  for name, fn in SCENARIOS.items()}))
"""


@fusable()
def k_hold(x):
    import torch
    return torch.as_tensor(x, dtype=torch.float32) * 2.0


def make_rts():
    return TorchRTS(devices=virtual_devices("cpu", 8), fusion_max_batch=8,
                    shard_min_members=8, shard_hold_s=30.0)


@pytest.fixture(scope="module")
def jax_seen():
    return run_jax(JAX_SOURCE)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hold_scenario_matches_jax(jax_seen, name):
    got = SCENARIOS[name](make_rts, Task, k_hold)
    assert got == jax_seen[name]


def test_hold_emits_bound_quanta():
    """Width 100 on 8 places of max_batch 8: ceil(100/64) = 2 dispatches,
    so 50-member quanta; the last arrival completes the width and flushes
    everything (the JAX package's numbers)."""
    seen = SCENARIOS["quanta"](make_rts, Task, k_hold)
    assert seen["first"] == [0, 30, 30]
    assert [n.split(":")[0] for n in seen["second"][0]] == ["shard[8x1x50]"]
    assert seen["second"][1] == 10
    assert seen["third"][1:] == [False, False]
    assert seen["shard_carriers"] == 2
    assert seen["slots"] == [8]


def test_hold_idle_flush_and_rearm():
    seen = SCENARIOS["rearm"](make_rts, Task, k_hold)
    assert seen["armed"] and seen["progress"] == [True, True, 10]
    assert seen["busy"] == [True, True]
    assert seen["stalled"][:2] == [False, 1]
    assert SCENARIOS["idle_flush"](make_rts, Task, k_hold)["flushed"]


def test_planned_group_slots_charges_whole_mesh():
    assert SCENARIOS["planned_slots"](make_rts, Task, k_hold) == \
        {"wide": 8, "wide2": 16, "narrow": 1}
