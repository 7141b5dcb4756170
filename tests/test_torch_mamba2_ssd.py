"""The port's Mamba-2 SSD scan against the JAX package.

Inputs come from numpy with a fixed seed and go through both packages. The
JAX kernel runs in Pallas interpret mode, as the JAX package's own tests
run it on the CPU; the port's wrapper takes its plain version for CPU
tensors. The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jm
from repro_torch.kernels import ref
from repro_torch.kernels.mamba2_ssd import (mamba2_ssd, mamba2_ssd_plain,
                                            pick_chunk)
from repro_torch.models import mamba2 as tm

SSD_SHAPES = [(1, 64, 2, 64, 1, 64), (2, 128, 4, 32, 2, 16),
              (1, 96, 3, 16, 1, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 6e-2)}


def _inputs(B, T, H, P, G, N, seed=0):
    """x, dt (softplus-ed), A (negative), Bm, Cm, state0 as f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, T, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T, G, N)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, P)) * 0.1).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _both(arrays, dtype):
    """x, Bm and Cm in ``dtype``; dt, A and state0 in f32 (as the model
    feeds them)."""
    jdt, tdt, _ = DTYPES[dtype]
    x, dt, A, Bm, Cm, s0 = arrays
    j = [jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt), jnp.asarray(s0)]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
         torch.from_numpy(Cm).to(tdt), torch.from_numpy(s0)]
    return j, t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_port_matches_jax_pallas_interpret(shape, dtype):
    j, t = _both(_inputs(*shape), dtype)
    jy, js = jops.mamba2_ssd(*j, chunk=32, interpret=True)
    y, s = mamba2_ssd(*t, chunk=32)
    assert y.dtype == t[0].dtype and y.shape == t[0].shape
    assert s.dtype == torch.float32 and s.shape == t[5].shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(y), _f32(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(s.numpy(), _f32(js), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(2, 96, 2, 16, 1, 8),
                                   (1, 100, 4, 16, 2, 8)])
def test_chunked_and_ref_match_jax(shape):
    j, t = _both(_inputs(*shape, seed=1), "float32")
    for port, jax_fn in ((lambda *a: mamba2_ssd_plain(*a, chunk=32),
                          lambda *a: jm.ssd_chunked(*a, chunk=32)),
                         (ref.ssd_ref, jref.ssd_ref)):
        y, s = port(*t)
        jy, js = jax_fn(*j)
        np.testing.assert_allclose(y.numpy(), _f32(jy), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(s.numpy(), _f32(js), atol=1e-4, rtol=1e-4)


def test_ragged_chunk_matches_step_by_step_ref():
    """T = 100: the chunk is 50, as the JAX wrapper picks it."""
    assert [pick_chunk(T) for T in (512, 100, 97, 30)] == [64, 50, 1, 30]
    _, t = _both(_inputs(1, 100, 3, 16, 1, 8, seed=2), "float32")
    y, s = mamba2_ssd(*t)
    ry, rs = ref.ssd_ref(*t)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), atol=1e-4, rtol=1e-4)


def test_wkv_ref_matches_jax_oracle():
    """The RWKV-6 step-by-step oracle against JAX's."""
    rng = np.random.default_rng(6)
    r, k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((2, 24, 2, 16)) * 0.5 - 2.0)
               ).astype(np.float32)
    u = (rng.standard_normal((2, 16)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((2, 2, 16, 16)) * 0.1).astype(np.float32)
    args = (r, k, v, w, u, s0)
    out, state = ref.wkv_ref(*(torch.from_numpy(a) for a in args))
    jout, jstate = jref.wkv_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(out.numpy(), _f32(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state.numpy(), _f32(jstate), atol=1e-5,
                               rtol=1e-5)


def test_decode_step_and_conv_match_jax():
    rng = np.random.default_rng(3)
    x, dt, A, Bm, Cm, s0 = _inputs(2, 1, 4, 16, 2, 8, seed=3)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], s0)
    y, s = tm.ssd_decode(*(torch.from_numpy(a) for a in args))
    jy, js = jm.ssd_decode(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), _f32(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), _f32(js), atol=1e-5, rtol=1e-5)
    xc = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ring = rng.standard_normal((2, 3, 6)).astype(np.float32)
    out, new_ring = tm.causal_conv(*(torch.from_numpy(a)
                                     for a in (xc, w, b, ring)))
    jout, jring = jm.causal_conv(*(jnp.asarray(a) for a in (xc, w, b, ring)))
    np.testing.assert_allclose(out.numpy(), _f32(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(new_ring.numpy(), _f32(jring))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    _, t = _both(_inputs(2, 128, 4, 32, 2, 16, seed=4), "bfloat16")
    before = mamba2_ssd.launches
    y, s = mamba2_ssd(*t)
    py, ps = mamba2_ssd_plain(*t)
    assert torch.equal(y, py) and torch.equal(s, ps)
    assert mamba2_ssd.launches == before   # no kernel launch on the CPU


@pytest.mark.parametrize("bad", ["dtype", "mixed", "dt_dtype", "groups",
                                 "state_shape", "strided", "state_dim",
                                 "chunk"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, t = _both(_inputs(1, 32, 4, 16, 2, 8, seed=5), "float32")
    x, dt, A, Bm, Cm, s0 = t
    kw = {}
    if bad == "dtype":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif bad == "mixed":
        Bm = Bm.bfloat16()
    elif bad == "dt_dtype":
        dt = dt.bfloat16()
    elif bad == "groups":
        x, A = x[:, :, :3].contiguous(), A[:3]
        dt, s0 = dt[:, :, :3].contiguous(), s0[:, :3].contiguous()
    elif bad == "state_shape":
        s0 = s0[:, :, :4].contiguous()
    elif bad == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "state_dim":
        Bm = torch.zeros(1, 32, 2, 136)
        Cm, s0 = Bm.clone(), torch.zeros(1, 4, 136, 16)
    else:
        kw["chunk"] = 128
    with pytest.raises((TypeError, ValueError)):
        mamba2_ssd(x, dt, A, Bm, Cm, s0, **kw)
