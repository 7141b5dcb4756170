"""Tests of the port that need an NVIDIA GPU: the CUDA kernel against its
plain version, and the workflow on the card against the same workflow on
the CPU. They skip where ``torch.cuda.is_available()`` is False. This file
imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

SHAPES = [(60, 3, 37), (9, 2, 130), (64, 3, 256), (365, 3, 512),
          (365, 3, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_bit_equal_to_plain(cuda, shape):
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_plain)
    h, v, n = shape
    rng = np.random.default_rng(7)
    fh = torch.from_numpy(rng.standard_normal((h, v, n)).astype(np.float32))
    fn = torch.from_numpy(rng.standard_normal((v, n)).astype(np.float32))
    fh, fn = fh.to(cuda), fn.to(cuda)
    before = anen_distance.launches
    got = anen_distance(fh, fn)
    torch.cuda.synchronize()
    assert anen_distance.launches == before + 1
    assert torch.equal(got, anen_distance_plain(fh, fn))


def test_workflow_on_card_matches_cpu(cuda):
    from repro_torch.apps.anen.workflow import run_adaptive
    kw = dict(seed=3, ny=20, nx=20, n_hist=30, per_iter=16, max_iters=2,
              n_tasks=4, slots=4, timeout=120)
    on_gpu = run_adaptive(device="cuda", **kw)
    on_cpu = run_adaptive(device="cpu", **kw)
    assert on_gpu["all_done"] and on_cpu["all_done"]
    stats = on_gpu["fusion_stats"]
    assert stats["fused"] > 0
    assert stats["scalar_fallback"] == 0 and stats["degraded"] == 0
    assert np.allclose(on_gpu["errors"], on_cpu["errors"], rtol=0, atol=1e-5)
