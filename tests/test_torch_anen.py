"""The port's AnEn numerics against the JAX package's, on the CPU.

The dataset must be bit-identical (both build it in numpy and cast to
float32 last); the numerics must agree within 1e-6 — float32 sums taken in
another order by XLA and by PyTorch differ in the last bits only.
"""

import numpy as np
import pytest
import torch

from repro.apps.anen import anen as janen
from repro_torch.apps.anen import anen as tanen

CFG = dict(ny=24, nx=20, n_hist=40, seed=5)


@pytest.fixture(scope="module")
def datasets():
    jdata = janen.make_dataset(janen.AnEnConfig(**CFG))
    tdata = tanen.make_dataset(tanen.AnEnConfig(**CFG), device="cpu")
    return jdata, tdata


def test_make_dataset_bit_identical(datasets):
    jdata, tdata = datasets
    for field in janen.AnEnData._fields:
        j = np.asarray(getattr(jdata, field))
        t = getattr(tdata, field)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert np.array_equal(j, t.numpy()), field


def test_dataset_from_numpy_of_jax_arrays_bit_identical(datasets):
    jdata, _ = datasets
    tdata = tanen.dataset_from_numpy(*(np.asarray(f) for f in jdata),
                                     device="cpu")
    for j, t in zip(jdata, tdata):
        assert np.array_equal(np.asarray(j), t.numpy())


def test_compute_analogs_matches_jax(datasets):
    jdata, tdata = datasets
    rng = np.random.default_rng(11)
    locs = np.stack([rng.integers(0, CFG["ny"], 50),
                     rng.integers(0, CFG["nx"], 50)], axis=1).astype(np.int32)
    ref = np.asarray(janen.compute_analogs(jdata, locs, 12))
    got = tanen.compute_analogs(tdata, torch.from_numpy(locs), 12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "integer_ties"])
def test_idw_interpolate_matches_jax(kind):
    ny, nx = 21, 17
    rng = np.random.default_rng(3)
    if kind == "integer_ties":
        # a regular lattice: most grid cells sit at equal distance from
        # several samples, so the top-k order of equal keys decides the set
        ys, xs = np.meshgrid(np.arange(1, ny, 4), np.arange(1, nx, 4),
                             indexing="ij")
        locs = np.stack([ys.ravel(), xs.ravel()], axis=1).astype(np.int32)
    else:
        flat = rng.choice(ny * nx, size=40, replace=False)
        locs = np.stack([flat // nx, flat % nx], axis=1).astype(np.int32)
    vals = rng.standard_normal(len(locs)).astype(np.float32)
    ref = np.asarray(janen.idw_interpolate(locs, vals, ny, nx))
    got = tanen.idw_interpolate(torch.from_numpy(locs),
                                torch.from_numpy(vals), ny, nx)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_idw_chunking_is_exact(monkeypatch):
    rng = np.random.default_rng(4)
    locs = torch.from_numpy(rng.integers(0, 30, (25, 2)).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal(25).astype(np.float32))
    whole = tanen.idw_interpolate(locs, vals, 30, 30)
    monkeypatch.setattr(tanen, "_IDW_CHUNK_ELEMS", 7 * 25)  # 7-row chunks
    assert torch.equal(tanen.idw_interpolate(locs, vals, 30, 30), whole)


def test_top_k_breaks_ties_to_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = tanen.top_k(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]


def test_gradient_magnitude_and_rmse_match_jax():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((13, 19)).astype(np.float32)
    b = rng.standard_normal((13, 19)).astype(np.float32)
    ref = np.asarray(janen.gradient_magnitude(a))
    got = tanen.gradient_magnitude(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert abs(tanen.rmse(torch.from_numpy(a), torch.from_numpy(b))
               - janen.rmse(a, b)) <= 1e-6
