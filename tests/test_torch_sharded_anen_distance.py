"""B2: the port's ``anen_distance_sharded`` against the JAX package's.

The JAX function runs in Pallas interpret mode on a 1-D mesh of 8 forced
host devices (a subprocess: ``shard_map`` needs the devices at start-up),
H padded by edge rows there too; the port splits H over 2, 3 and 8 lanes
of the CPU, where each shard takes B1's plain version. Inputs come from
numpy with a fixed seed. The tolerance is the port's B1 tolerance
(``tests/test_torch_anen_distance.py``). On the card, B1's CUDA kernel
runs once per place (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from _torch_sharded import run_jax
from repro_torch.device import virtual_devices
from repro_torch.kernels import anen_distance as kmod
from repro_torch.kernels.anen_distance import (anen_distance_plain,
                                               anen_distance_sharded)

HS = (30, 37, 365)
V, N = 3, 20
PLACES = (2, 3, 8)

JAX_SOURCE = """
import json
import numpy as np
import jax
from repro.kernels.anen_distance import anen_distance_sharded

out = {}
for h in __HS__:
    rng = np.random.default_rng(h)
    fh = rng.standard_normal((h, __V__, __N__)).astype(np.float32)
    fn = rng.standard_normal((__V__, __N__)).astype(np.float32)
    got = anen_distance_sharded(fh, fn, devices=jax.devices(),
                                interpret=True)
    out[str(h)] = np.asarray(got).tolist()
print(json.dumps(out))
"""


def _inputs(h):
    rng = np.random.default_rng(h)
    fh = rng.standard_normal((h, V, N)).astype(np.float32)
    fn = rng.standard_normal((V, N)).astype(np.float32)
    return torch.from_numpy(fh), torch.from_numpy(fn)


@pytest.fixture(scope="module")
def jax_out():
    return run_jax(JAX_SOURCE.replace("__HS__", repr(HS))
                   .replace("__V__", str(V)).replace("__N__", str(N)))


@pytest.mark.parametrize("h", HS)
@pytest.mark.parametrize("places", PLACES)
def test_sharded_matches_jax_sharded(jax_out, h, places):
    fh, fn = _inputs(h)
    got = anen_distance_sharded(fh, fn, virtual_devices("cpu", places))
    assert got.shape == (h, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out[str(h)]),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(got, anen_distance_plain(fh, fn))


@pytest.mark.parametrize("places", PLACES)
def test_one_launch_a_place(places):
    fh, fn = _inputs(37)
    before = kmod.anen_distance_sharded.launches
    shapes = dict(kmod.anen_distance_sharded.shapes)
    anen_distance_sharded(fh, fn, virtual_devices("cpu", places))
    assert kmod.anen_distance_sharded.launches == before + places
    per = -(-37 // places)
    assert kmod.anen_distance_sharded.shapes[(per, V, N)] == \
        shapes.get((per, V, N), 0) + places


def test_fewer_than_two_places_is_b1():
    fh, fn = _inputs(30)
    before = kmod.anen_distance_sharded.launches
    lane = virtual_devices("cpu", 1)
    for devices in (None, [], lane, lane * 3):
        got = anen_distance_sharded(fh, fn, devices)
        assert torch.equal(got, anen_distance_plain(fh, fn))
    assert kmod.anen_distance_sharded.launches == before


def test_cuda_places_with_cpu_tensors_raise():
    """A mesh of CUDA places never quietly computes on the CPU (placed by
    name: nothing touches CUDA before the check)."""
    fh, fn = _inputs(30)
    with pytest.raises(ValueError, match="places on"):
        anen_distance_sharded(fh, fn, [torch.device("cuda", 0),
                                       torch.device("cuda", 1)])

