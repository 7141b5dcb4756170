"""The backward of the port's RWKV-6 WKV recurrence against autograd and
JAX.

The JAX package has no backward kernel for this recurrence: it trains
through ``jax.grad`` of its chunked reference ``models/rwkv6.py::
wkv_chunked``. The port's backward (``rwkv6_wkv_bwd``) computes that
gradient; on the CPU it takes ``rwkv6_wkv_bwd_plain``. Inputs come from
numpy with a fixed seed, drawn as the JAX kernel test draws them, with a
random output gradient and (unless None) a random final-state gradient.
Two draws reach the clamps: ``clamped`` has channels whose decay drives
the in-chunk cumsum below -30 and steps with w < 1e-8 (no gradient flows
through either clamp; the draws stay off the ties, where ``jnp.maximum``
splits the gradient and ``torch.clamp`` does not). The plain backward is
held to ``torch.autograd.grad`` through the plain forward leaf by leaf,
normwise, in float64 (the plain versions keep f64 inputs in f64, so no
wrong term hides under f32 rounding) within 1e-10; to ``jax.grad`` of
``wkv_chunked`` within the JAX gradient tolerance 5e-4 (atol = rtol;
``tests/test_kernels.py``) in f32 and within the WKV bf16 tolerance 5e-2
for bf16 r, k, v, w. The CUDA backward kernel is held against the plain
version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jm
from repro_torch.kernels.rwkv6_wkv import (rwkv6_wkv, rwkv6_wkv_bwd,
                                           rwkv6_wkv_bwd_plain,
                                           rwkv6_wkv_plain)

# (B, T, H, N): T = 128 (chunk 64), 100 (chunk 50) and 7 (chunk 7), N = 16,
# 8, 5 and the model's 64
SHAPES = [(1, 128, 2, 16), (2, 100, 3, 8), (1, 7, 2, 5), (1, 64, 1, 64)]
DRAWS = ["plain", "clamped"]
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")
NORMWISE = 1e-10        # float64
JAX_F32_TOL = 5e-4
JAX_BF16_TOL = 5e-2


def _inputs(B, T, H, N, seed=0, draw="plain"):
    """r, k, v ~ N/2, w = exp(-exp(N/2 - 2)), u ~ 0.3 N, state0 ~ N/10, the
    output and final-state gradients ~ N, as f32 numpy. ``clamped``: a
    quarter of the channels decay by e^-0.5..e^-3 a step (the cumsum
    passes -30 inside a chunk), and every 7th step of channel 1 has
    w = 1e-9."""
    rng = np.random.default_rng(seed)

    def normal(*s):
        return rng.standard_normal(s).astype(np.float32)

    r, k, v = (normal(B, T, H, N) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(normal(B, T, H, N) * 0.5 - 2.0))
    if draw == "clamped":
        q = max(1, N // 4)
        w[..., :q] = np.exp(-rng.uniform(0.5, 3.0, (B, T, H, q)))
        w[:, 3::7, :, min(1, N - 1)] = 1e-9
    return (r, k, v, w.astype(np.float32), normal(H, N) * 0.3,
            normal(B, H, N, N) * 0.1, normal(B, T, H, N), normal(B, H, N, N))


def _torch(arrays, dtype=torch.float32):
    """r, k, v, w and the output gradient in ``dtype``; the rest f32 (f64
    for f64)."""
    rest = torch.float64 if dtype == torch.float64 else torch.float32
    out = [torch.from_numpy(np.ascontiguousarray(a)).to(rest)
           for a in arrays]
    for i in (0, 1, 2, 3, 6):
        out[i] = out[i].to(dtype)
    return out


def _normwise(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def test_clamped_draw_reaches_both_clamps():
    r, k, v, w, *_ = _inputs(1, 128, 2, 16, seed=1, draw="clamped")
    cum = np.cumsum(np.log(np.maximum(w.reshape(1, 2, 64, 2, 16), 1e-8)),
                    axis=2)
    assert (cum < -30.0).any() and (w < 1e-8).any()
    assert not np.isclose(cum, -30.0, atol=1e-4).any()


@functools.lru_cache(maxsize=None)
def _jax_grads(shape, seed, draw, with_ds, bf16):
    arrays = _inputs(*shape, seed=seed, draw=draw)
    dt_ = jnp.bfloat16 if bf16 else jnp.float32
    r, k, v, w, u, s0 = (jnp.asarray(a, dt_) if i < 4 else jnp.asarray(a)
                         for i, a in enumerate(arrays[:6]))
    dout, dsT = jnp.asarray(arrays[6]), jnp.asarray(arrays[7])

    def loss(*args):
        out, s = jm.wkv_chunked(*args, chunk=64)
        total = (out.astype(jnp.float32) * dout).sum()
        return total + (s * dsT).sum() if with_ds else total

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        r, k, v, w, u, s0)
    return [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("with_ds", [True, False])
@pytest.mark.parametrize("draw", DRAWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_through_plain_forward(shape, draw,
                                                               with_ds):
    *ins, dout, dsT = _torch(_inputs(*shape, seed=1, draw=draw),
                             torch.float64)
    leaves = [a.clone().requires_grad_(True) for a in ins]
    out, s = rwkv6_wkv_plain(*leaves)
    loss = (out * dout).sum() + ((s * dsT).sum() if with_ds else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = rwkv6_wkv_bwd_plain(*ins, dout, dsT if with_ds else None)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _normwise(g, w) <= NORMWISE, (name, _normwise(g, w))


@pytest.mark.parametrize("draw", DRAWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_grad(shape, draw):
    want = _jax_grads(shape, 2, draw, True, False)
    *ins, dout, dsT = _torch(_inputs(*shape, seed=2, draw=draw))
    got = rwkv6_wkv_bwd_plain(*ins, dout, dsT)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=JAX_F32_TOL,
                                   rtol=JAX_F32_TOL, err_msg=name)


def test_plain_backward_without_dstate_matches_jax_grad():
    shape = SHAPES[1]
    want = _jax_grads(shape, 2, "clamped", False, False)
    *ins, dout, _ = _torch(_inputs(*shape, seed=2, draw="clamped"))
    got = rwkv6_wkv_bwd_plain(*ins, dout, None)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=JAX_F32_TOL,
                                   rtol=JAX_F32_TOL, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_plain_backward_bf16_matches_jax_grad(shape):
    """bf16 r, k, v, w (and the output gradient, as the train step feeds
    it): both sides sum in f32 and round dr, dk, dv, dw once to bf16."""
    want = _jax_grads(shape, 3, "plain", True, True)
    *ins, dout, dsT = _torch(_inputs(*shape, seed=3), torch.bfloat16)
    got = rwkv6_wkv_bwd_plain(*ins, dout, dsT)
    for name, g, a, w in zip(NAMES, got, ins, want):
        assert g.dtype == a.dtype, name
        np.testing.assert_allclose(g.float().numpy(), w, atol=JAX_BF16_TOL,
                                   rtol=JAX_BF16_TOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_records_the_function_on_the_cpu(dtype):
    """Under grad, ``rwkv6_wkv`` records its autograd.Function on the CPU
    too: ``autograd.grad`` through it is the plain backward, gradients go
    only to the inputs that require one, each in its input's dtype, and
    the wrapper counts no launch."""
    *ins, dout, dsT = _torch(_inputs(2, 100, 3, 8, seed=4), dtype)
    needs = (True, True, False, True, True, False)
    leaves = [a.clone().requires_grad_(n) for a, n in zip(ins, needs)]
    before = (rwkv6_wkv.launches, rwkv6_wkv_bwd.launches)
    out, s = rwkv6_wkv(*leaves)
    assert type(out.grad_fn).__name__ == "_RwkvWKVBackward"
    got = torch.autograd.grad((out.float() * dout.float()).sum()
                              + (s * dsT).sum(),
                              [a for a, n in zip(leaves, needs) if n])
    want = rwkv6_wkv_bwd_plain(*ins, dout, dsT)
    for g, w, a in zip(got, [w for w, n in zip(want, needs) if n],
                       [a for a, n in zip(ins, needs) if n]):
        assert g.dtype == a.dtype
        assert torch.equal(g, w)
    assert (rwkv6_wkv.launches, rwkv6_wkv_bwd.launches) == before


def test_wrapper_rejects_a_bad_output_gradient():
    *ins, dout, dsT = _torch(_inputs(1, 32, 2, 8, seed=6))
    with pytest.raises(ValueError):
        rwkv6_wkv_bwd(*ins, dout.bfloat16(), dsT)
    with pytest.raises(ValueError):
        rwkv6_wkv_bwd(*ins, dout, dsT[:, :1].contiguous())
