"""The port's anen_distance against the JAX package's Pallas kernel.

Inputs come from numpy with a fixed seed and go through both packages.
The JAX kernel runs in Pallas interpret mode, as the JAX package's own
tests run it on the CPU; the port's wrapper takes its plain version for CPU
tensors. The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from repro.kernels.anen_distance import anen_distance as jax_anen_distance
from repro_torch.kernels import _build
from repro_torch.kernels import anen_distance as kmod
from repro_torch.kernels.anen_distance import (anen_distance,
                                               anen_distance_plain)

SHAPES = [(60, 3, 37), (9, 2, 130), (64, 3, 256)]


def _inputs(h, v, n, seed=7):
    rng = np.random.default_rng(seed)
    fh = rng.standard_normal((h, v, n)).astype(np.float32)
    fn = rng.standard_normal((v, n)).astype(np.float32)
    return fh, fn


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_pallas_interpret(shape):
    fh, fn = _inputs(*shape)
    ref = np.asarray(jax_anen_distance(fh, fn, interpret=True))
    got = anen_distance_plain(torch.from_numpy(fh), torch.from_numpy(fn))
    assert got.shape == shape[::2] and got.dtype == torch.float32
    # same summation order on both sides; 1e-6 relative covers XLA's
    # freedom to contract the multiply-add in interpret mode
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_takes_plain_version_for_cpu_tensors(shape):
    fh, fn = (torch.from_numpy(a) for a in _inputs(*shape))
    before = anen_distance.launches
    got = anen_distance(fh, fn)
    assert torch.equal(got, anen_distance_plain(fh, fn))
    assert anen_distance.launches == before   # no kernel launch on the CPU


@pytest.mark.parametrize("bad", [
    lambda fh, fn: (fh.double(), fn.double()),                # dtype
    lambda fh, fn: (fh[0], fn),                               # rank
    lambda fh, fn: (fh, fn[:, :-1]),                          # shape
    lambda fh, fn: (fh.transpose(0, 2).contiguous().transpose(0, 2), fn),
    lambda fh, fn: (fh.repeat(1, 6, 1), fn.repeat(6, 1)),     # V > 16
    lambda fh, fn: (fh.to("meta"), fn.to("meta")),            # device
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    fh, fn = (torch.from_numpy(a) for a in _inputs(8, 3, 16))
    with pytest.raises((TypeError, ValueError)):
        anen_distance(*bad(fh, fn))


def test_cuda_path_raises_without_toolkit(monkeypatch, tmp_path):
    """The CUDA path builds its kernel or raises: without nvcc there is no
    quiet fallback to the plain version."""
    monkeypatch.setattr(kmod, "_launcher", None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kmod.build()
