"""The data-axis mean of int8 compression (``ef_compressed_mean`` with an
``axis_name``) on a gloo group of 4 processes, held to the JAX package's
``shard_map`` ``pmean`` on 4 forced host devices.

Both sides take the same per-rank gradients and first error states
(``tests/_torch_ranks.py``: a nested dict of f32 and bf16 leaves, made
from a seed with numpy) for two steps of error feedback, over three axes:
the default group (JAX: a 1-D mesh of 4), and each dimension of a (2, 2)
``("data", "model")`` mesh, named through a ``DeviceMesh`` and through the
port's ``Mesh`` carrying one. The error states must be equal bits (they
are rank-local); the means within 1e-6 of the leaf's largest, relative
(the order of the sum may differ)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_sharded import run_jax

WORLD = 4
# The port rounds op by op, as JAX does eagerly. Under jit XLA's algebraic
# simplifier turns the scale's ``/ 127.0`` into a product with the
# reciprocal, and on a CPU with FMA it contracts ``target - q * scale`` into
# one fused multiply-add: other roundings than the function's ops. These
# flags keep the jitted shard_map op for op (eager shard_map compiles every
# op anew, ~45 s); the subprocess checks that they do.
OP_FOR_OP = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"

JAX_SOURCE = """
import json
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

import _torch_ranks as ranks
from repro.optim import compression as jcomp

# the flags hold: one device's jitted compression equals its eager one
for k, (_, dt) in ranks.LEAVES.items():
    g = jnp.asarray(ranks.grads(0, 0)[k]).astype(getattr(jnp, dt))
    e = jnp.asarray(ranks.first_error(0)[k])
    for a, b in zip(jcomp.ef_compressed_mean(g, e),
                    jax.jit(jcomp.ef_compressed_mean)(g, e)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), k

# one (2, 2) mesh for every case: the default group of 4 is the mean over
# both of its axes
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
spec = P(("data", "model"))
saved = {}
for case, (shape, axis) in ranks.CASES.items():
    axis = ("data", "model") if shape is None else axis

    def step_fn(g, e, axis=axis):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        mean, err = jcomp.ef_compressed_mean(g, e, axis_name=axis)
        return (jax.tree.map(lambda x: x[None], mean),
                jax.tree.map(lambda x: x[None], err))

    fn = jax.jit(jax.shard_map(step_fn, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec), check_vma=False))
    dtypes = {k: getattr(jnp, dt) for k, (_, dt) in ranks.LEAVES.items()}
    err = ranks.nest({k: jnp.stack([ranks.first_error(r)[k]
                                    for r in range(4)])
                      for k in ranks.LEAVES})
    for step in range(ranks.STEPS):
        g = ranks.nest({k: jnp.stack([ranks.grads(r, step)[k]
                                      for r in range(4)]).astype(dtypes[k])
                        for k in ranks.LEAVES})
        mean, err = fn(g, err)
        for name, v in ranks.flatten(mean):
            assert v.dtype == dtypes[name]
            saved[f"{case}/{step}/mean/{name}"] = np.asarray(
                v.astype(jnp.float32))
        for name, v in ranks.flatten(err):
            saved[f"{case}/{step}/error/{name}"] = np.asarray(v)
np.savez(__OUT__, **saved)
print(json.dumps({"keys": sorted(saved)}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    out = str(work / "jax.npz")
    # the JAX subprocess and the 4 ranks run at the same time
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_jax, JAX_SOURCE.replace("__OUT__",
                                                          repr(out)),
                              devices=WORLD, xla_flags=OP_FOR_OP)
        port = ranks.spawn(WORLD, "gloo", "cpu", str(work))
        keys = jax_run.result()["keys"]
    jax_out = dict(np.load(out))
    assert sorted(jax_out) == keys
    return port, jax_out


def _keys(kind):
    return [f"{case}/{step}/{kind}/{name}" for case in ranks.CASES
            for step in range(ranks.STEPS) for name in ranks.LEAVES]


@pytest.mark.parametrize("key", _keys("error"))
def test_error_state_equals_jax_bits(runs, key):
    port, jax_out = runs
    got = np.stack([port[r][key] for r in range(WORLD)])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32),
                                  jax_out[key].view(np.uint32))


@pytest.mark.parametrize("key", _keys("mean"))
def test_mean_over_the_axis_matches_jax(runs, key):
    port, jax_out = runs
    got = np.stack([port[r][key] for r in range(WORLD)])
    want = jax_out[key]
    assert np.all(np.isfinite(got))
    # relative to the leaf's largest mean: a sum of 4 terms in another
    # order moves a near-cancelling element by ulps of its terms
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_the_mean_is_the_axis_groups():
    """The three cases average over different groups: the default group
    of 4, then pairs along ``data`` and along ``model``."""
    assert ranks.CASES["world"][0] is None
    assert {ranks.CASES[c][1] for c in ("mesh_data", "mesh_model")} == \
        {"data", "model"}


def test_the_plain_mean_matches_the_group_run(runs):
    """The CPU reference the card checks use (``_torch_ranks.expected``)
    gives the gloo run's error bits and its means within 1e-6."""
    port, _ = runs
    for case in ranks.CASES:
        want = ranks.expected(WORLD, case)
        for r in range(WORLD):
            for key, v in want[r].items():
                got = port[r][key]
                if "/error/" in key:
                    np.testing.assert_array_equal(got.view(np.uint32),
                                                  v.view(np.uint32))
                else:
                    np.testing.assert_allclose(
                        got, v, rtol=0, atol=1e-6 * np.abs(v).max())
