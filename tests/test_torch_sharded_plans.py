"""The sharded tier's plans against the JAX package's: ``build_mesh``'s
rules, ``shard_pad`` and ``TorchRTS._plan_mesh`` over a grid of group
widths, slot counts and place counts, held to ``JaxRTS._plan_mesh`` on 8
forced host devices (a subprocess, as ``tests/test_shard.py`` runs its
multi-device cases); and the virtual devices the port's mesh is built of."""

import pytest
import torch

from _torch_sharded import run_jax
from repro_torch.device import VirtualDevice, place_device, virtual_devices
from repro_torch.fusion import engine as fengine
from repro_torch.rts.torch_rts import TorchRTS

WIDTHS = [1, 7, 8, 9, 63, 64, 65, 100, 513, 1000, 4097, 9000]
PLACES = [1, 2, 3, 4, 8]
SLOTS = [1, 2, 4, 8, 16]
SHARD_COUNTS = [1, 2, 3, 4, 7, 8, 16]

JAX_SOURCE = """
import json
import jax
from repro.fusion import engine
from repro.rts.jax_rts import JaxRTS

WIDTHS, PLACES, SLOTS, SHARDS = %r, %r, %r, %r
devs = jax.devices()
out = {"pad": [[engine.shard_pad(n, d) for d in SHARDS] for n in WIDTHS],
       "plans": {}, "mesh": {}}
for k in PLACES:
    for member_slots in (1, 2):
        for max_batch in (8, 4096):
            for min_members in (8, 64):
                rts = JaxRTS(devices=devs[:k], fusion_max_batch=max_batch,
                             shard_min_members=min_members)
                for slots in SLOTS:
                    rts._slots_total = slots
                    for n in WIDTHS:
                        p = rts._plan_mesh(n, slots, member_slots, None)
                        key = f"{k}/{member_slots}/{max_batch}/" \\
                              f"{min_members}/{slots}/{n}"
                        out["plans"][key] = None if p is None else [
                            p.n_shards, list(p.batches), p.record()]
d = devs
cases = {"empty": [], "placeholders": ["d0", "d1"], "twice": [d[0], d[0]],
         "one": [d[0]], "two": d[:2], "four": d[:4], "eight": d[:8]}
for name, lease in cases.items():
    mesh = engine.build_mesh(lease)
    out["mesh"][name] = None if mesh is None else int(mesh.devices.size)
print(json.dumps(out))
""" % (WIDTHS, PLACES, SLOTS, SHARD_COUNTS)


@pytest.fixture(scope="module")
def jax_plans():
    return run_jax(JAX_SOURCE)


def test_shard_pad_matches_jax(jax_plans):
    got = [[fengine.shard_pad(n, d) for d in SHARD_COUNTS] for n in WIDTHS]
    assert got == jax_plans["pad"]


@pytest.mark.parametrize("k", PLACES)
def test_plan_mesh_matches_jax(jax_plans, k):
    """Over widths, member slots, batch caps, thresholds and pilot slot
    totals, the port plans the JAX package's mesh (or none) on k places."""
    n_plans = 0
    for member_slots in (1, 2):
        for max_batch in (8, 4096):
            for min_members in (8, 64):
                rts = TorchRTS(devices=virtual_devices("cpu", k),
                               fusion_max_batch=max_batch,
                               shard_min_members=min_members)
                for slots in SLOTS:
                    rts._slots_total = slots
                    for n in WIDTHS:
                        p = rts._plan_mesh(n, slots, member_slots, None)
                        key = (f"{k}/{member_slots}/{max_batch}/"
                               f"{min_members}/{slots}/{n}")
                        got = None if p is None else [
                            p.n_shards, list(p.batches), p.record()]
                        assert got == jax_plans["plans"][key], key
                        n_plans += p is not None
    assert (n_plans > 0) == (k >= 2)


def test_plan_mesh_opt_outs():
    rts = TorchRTS(devices=virtual_devices("cpu", 4), shard_min_members=8)
    rts._slots_total = 4
    assert rts._plan_mesh(64, 4, 1, None).n_shards == 4
    assert rts._plan_mesh(64, 4, 1, {"_no_shard": True}) is None
    assert TorchRTS(devices=virtual_devices("cpu", 4), shard=False) \
        ._plan_mesh(64, 4, 1, None) is None
    # a device listed twice, or logical slots over one card, never mesh
    twice = TorchRTS(devices=[torch.device("cuda", 0)] * 4)
    twice._slots_total = 4
    assert twice._plan_mesh(64, 4, 1, None) is None


@pytest.mark.parametrize("name,lease,size", [
    ("empty", [], None),
    ("placeholders", ["d0", "d1"], None),
    ("twice", [VirtualDevice("cpu", 0)] * 2, None),
    ("two", virtual_devices("cpu", 2), 2),
    ("four", virtual_devices("cpu", 4), 4),
    ("eight", virtual_devices("cpu", 8), 8)])
def test_build_mesh_matches_jax(jax_plans, name, lease, size):
    mesh = fengine.build_mesh(lease)
    assert (None if mesh is None else mesh.size) == size
    assert jax_plans["mesh"][name] == size
    if mesh is not None:
        assert mesh.places == lease and mesh.places[0] == lease[0]


def test_build_mesh_port_rules(jax_plans):
    """Beyond JAX's cases: one place is no mesh (the JAX package builds a
    1-device mesh there; the port runs that carrier unsharded), lanes of
    two devices or a mix of lanes and cards never mesh, and two distinct
    CUDA devices do, without touching CUDA."""
    assert jax_plans["mesh"]["one"] == 1
    assert fengine.build_mesh(virtual_devices("cpu", 1)) is None
    assert fengine.build_mesh([VirtualDevice("cpu", 0),
                               VirtualDevice("cuda:0", 1)]) is None
    assert fengine.build_mesh([VirtualDevice("cuda:0", 0),
                               torch.device("cuda", 1)]) is None
    assert fengine.build_mesh([torch.device("cpu")]) is None
    assert fengine.build_mesh([torch.device("cuda", 0),
                               torch.device("cuda", 0)]) is None
    mesh = fengine.build_mesh([torch.device("cuda", 0),
                               torch.device("cuda", 1)])
    assert mesh is not None and mesh.devices == [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)]


def test_virtual_devices():
    lanes = virtual_devices("cpu", 3)
    assert [v.lane for v in lanes] == [0, 1, 2]
    assert len(set(lanes)) == 3
    assert lanes[1] == VirtualDevice("cpu", 1)
    assert lanes[1] != VirtualDevice("cpu", 2)
    assert all(v.device == torch.device("cpu") and v.stream is None
               for v in lanes)
    assert place_device(lanes[2]) == torch.device("cpu")
    assert place_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        virtual_devices("cpu", 0)


def test_virtual_cuda_devices_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: lanes of it are made")
    with pytest.raises(RuntimeError):
        virtual_devices("cuda", 2)


def test_default_inventory_plans_no_mesh():
    """One device, as ``TorchRTS()`` on one card: no mesh, as JaxRTS on
    one device."""
    rts = TorchRTS(devices=[torch.device("cuda", 0)])
    rts._slots_total = 16
    assert rts._plan_mesh(10_000, 16, 1, None) is None
    assert rts.planned_group_slots(10_000, 1) == 1
