"""The backward of the port's Mamba-2 SSD scan against autograd and JAX.

The JAX package has no backward kernel for this scan: it trains through
``jax.grad`` of its chunked reference ``models/mamba2.py::ssd_chunked``.
The port's backward (``mamba2_ssd_bwd``) computes that gradient; on the
CPU it takes ``mamba2_ssd_bwd_plain``. Inputs come from numpy with a fixed
seed, drawn as the JAX kernel tests draw them, with a random output
gradient dy and (unless None) a random final-state gradient dstate_T. The
plain backward is held to ``torch.autograd.grad`` through the plain
forward leaf by leaf, normwise, in float64 (the plain versions keep f64
inputs in f64): in f32 the two differ by rounding alone up to about 1e-5
on dA, a sum over B and T with cancellation, where each side's own f32
error is of that size; in f64 they agree within 1e-10, so no wrong term
hides under rounding. It is held to
``jax.grad`` of ``ssd_chunked`` within the JAX gradient tolerance 5e-4
(atol = rtol; ``tests/test_kernels.py``) in f32 and within the SSD bf16
tolerance 6e-2 for bf16 x, B, C. The CUDA backward kernel is held against
the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm
from repro_torch.kernels.mamba2_ssd import (mamba2_ssd, mamba2_ssd_bwd,
                                            mamba2_ssd_bwd_plain,
                                            mamba2_ssd_plain, pick_chunk)

# (B, T, H, P, G, N): T = 128 (chunk 64), 100 (chunk 50) and 7 (chunk 7);
# G = 1 and 2; N != P throughout
SHAPES = [(1, 128, 2, 16, 1, 8), (2, 100, 4, 16, 2, 8), (1, 7, 2, 8, 2, 4),
          (2, 128, 4, 8, 2, 16)]
NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dstate0")
NORMWISE = 1e-10        # float64
JAX_F32_TOL = 5e-4
JAX_BF16_TOL = 6e-2


def _inputs(B, T, H, P, G, N, seed=0):
    """x, dt (softplus-ed), A (negative), Bm, Cm, state0, dy, dstate_T as
    f32 numpy."""
    rng = np.random.default_rng(seed)

    def draw(*s):
        return rng.standard_normal(s).astype(np.float32)

    return (draw(B, T, H, P), np.log1p(np.exp(draw(B, T, H))),
            -np.exp(draw(H) * 0.5), draw(B, T, G, N) * 0.5,
            draw(B, T, G, N) * 0.5, draw(B, H, N, P) * 0.1, draw(B, T, H, P),
            draw(B, H, N, P))


def _torch(arrays, dtype=torch.float32):
    """x, Bm, Cm, dy in ``dtype``; the rest f32 (f64 for f64)."""
    rest = torch.float64 if dtype == torch.float64 else torch.float32
    out = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(rest)
           for a in arrays]
    for i in (0, 3, 4, 6):
        out[i] = out[i].to(dtype)
    return out


def _normwise(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


@functools.lru_cache(maxsize=None)
def _jax_grads(shape, seed, with_ds, bf16):
    arrays = _inputs(*shape, seed=seed)
    dt_ = jnp.bfloat16 if bf16 else jnp.float32
    x, dt, A, Bm, Cm, s0 = (jnp.asarray(a, dt_) if i in (0, 3, 4) else
                            jnp.asarray(a) for i, a in enumerate(arrays[:6]))
    dy, dsT = jnp.asarray(arrays[6]), jnp.asarray(arrays[7])

    def loss(*args):
        y, s = jm.ssd_chunked(*args, chunk=64)
        total = (y.astype(jnp.float32) * dy).sum()
        return total + (s * dsT).sum() if with_ds else total

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        x, dt, A, Bm, Cm, s0)
    return [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("with_ds", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_through_plain_forward(shape,
                                                               with_ds):
    *ins, dy, dsT = _torch(_inputs(*shape, seed=1), torch.float64)
    leaves = [a.clone().requires_grad_(True) for a in ins]
    y, s = mamba2_ssd_plain(*leaves)
    loss = (y * dy).sum() + ((s * dsT).sum() if with_ds else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = mamba2_ssd_bwd_plain(*ins, dy, dsT if with_ds else None)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if with_ds or name != "dstate0" or w.abs().max() > 0:
            assert _normwise(g, w) <= NORMWISE, (name, _normwise(g, w))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_grad(shape):
    want = _jax_grads(shape, 2, True, False)
    *ins, dy, dsT = _torch(_inputs(*shape, seed=2))
    got = mamba2_ssd_bwd_plain(*ins, dy, dsT)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=JAX_F32_TOL,
                                   rtol=JAX_F32_TOL, err_msg=name)


def test_plain_backward_without_dstate_matches_jax_grad():
    shape = SHAPES[1]
    want = _jax_grads(shape, 2, False, False)
    *ins, dy, _ = _torch(_inputs(*shape, seed=2))
    got = mamba2_ssd_bwd_plain(*ins, dy, None)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=JAX_F32_TOL,
                                   rtol=JAX_F32_TOL, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_plain_backward_bf16_matches_jax_grad(shape):
    """bf16 x, B, C (and dy, as the train step feeds it): both sides sum in
    f32 and round dx, dB, dC once to bf16."""
    want = _jax_grads(shape, 3, True, True)
    *ins, dy, dsT = _torch(_inputs(*shape, seed=3), torch.bfloat16)
    got = mamba2_ssd_bwd_plain(*ins, dy, dsT)
    for name, g, a, w in zip(NAMES, got, ins, want):
        assert g.dtype == a.dtype, name
        np.testing.assert_allclose(g.float().numpy(), w, atol=JAX_BF16_TOL,
                                   rtol=JAX_BF16_TOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_records_the_function_on_the_cpu(dtype):
    """Under grad, ``mamba2_ssd`` records its autograd.Function on the CPU
    too: ``autograd.grad`` through it is the plain backward, gradients go
    only to the inputs that require one, each in its input's dtype, and
    the wrapper counts no launch."""
    *ins, dy, dsT = _torch(_inputs(2, 100, 4, 16, 2, 8, seed=4), dtype)
    needs = (True, True, False, True, False, True)
    leaves = [a.clone().requires_grad_(n) for a, n in zip(ins, needs)]
    before = (mamba2_ssd.launches, mamba2_ssd_bwd.launches)
    y, s = mamba2_ssd(*leaves)
    assert type(y.grad_fn).__name__ == "_MambaSSDBackward"
    got = torch.autograd.grad((y.float() * dy.float()).sum()
                              + (s * dsT).sum(),
                              [a for a, n in zip(leaves, needs) if n])
    want = mamba2_ssd_bwd_plain(*ins, dy, dsT)
    for g, w, a in zip(got, [w for w, n in zip(want, needs) if n],
                       [a for a, n in zip(ins, needs) if n]):
        assert g.dtype == a.dtype
        assert torch.equal(g, w)
    assert (mamba2_ssd.launches, mamba2_ssd_bwd.launches) == before


def test_function_passes_none_for_an_unused_state():
    """A train step uses y only: the final state's gradient reaches the
    backward as None (zeros), with the contiguous slices the model feeds
    keeping their gradients."""
    *ins, dy, _ = _torch(_inputs(1, 64, 2, 8, 1, 4, seed=5))
    xbc = torch.cat([ins[0].reshape(1, 64, 16), ins[3].reshape(1, 64, 4),
                     ins[4].reshape(1, 64, 4)], -1).requires_grad_(True)
    x = xbc[..., :16].reshape(1, 64, 2, 8)
    Bm, Cm = xbc[..., 16:20].reshape(1, 64, 1, 4), xbc[..., 20:]
    y, _ = mamba2_ssd(x.contiguous(), ins[1], ins[2], Bm.contiguous(),
                      Cm.reshape(1, 64, 1, 4).contiguous(), ins[5])
    (g,) = torch.autograd.grad((y * dy).sum(), [xbc])
    dx, _, _, dB, dC, _ = mamba2_ssd_bwd_plain(*ins, dy, None)
    want = torch.cat([dx.reshape(1, 64, 16), dB.reshape(1, 64, 4),
                      dC.reshape(1, 64, 4)], -1)
    assert torch.equal(g, want)


def test_wrapper_rejects_a_bad_output_gradient():
    *ins, dy, dsT = _torch(_inputs(1, 32, 2, 8, 1, 4, seed=6))
    with pytest.raises(ValueError):
        mamba2_ssd_bwd(*ins, dy.bfloat16(), dsT)
    with pytest.raises(ValueError):
        mamba2_ssd_bwd(*ins, dy, dsT[:, :1].contiguous())
    assert pick_chunk(7) == 7 and pick_chunk(100) == 50
