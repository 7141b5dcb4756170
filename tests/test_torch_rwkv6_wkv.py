"""The port's RWKV-6 WKV recurrence against the JAX package.

Inputs come from numpy with a fixed seed and go through both packages, drawn
as the JAX kernel test draws them (``tests/test_kernels.py``). The JAX
kernel runs in Pallas interpret mode, as the JAX package's own tests run it
on the CPU; the port's wrapper takes its plain version for CPU tensors. The
CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rwkv6_wkv as jkernel
from repro.models import rwkv6 as jm
from repro_torch.kernels import ref
from repro_torch.kernels.rwkv6_wkv import (pick_chunk, rwkv6_wkv,
                                           rwkv6_wkv_plain)
from repro_torch.models import rwkv6 as tm

# the JAX kernel test's shapes (B, T, H, N), then a ragged T (chunk 50 at
# the default 64) and a prime T (chunk 1)
WKV_SHAPES = [(1, 64, 1, 64), (2, 128, 3, 64), (1, 96, 2, 64)]
RAGGED_SHAPES = [(2, 100, 2, 64), (1, 97, 2, 16)]
# out tolerance (atol = rtol) of the JAX kernel test; the state's is 10x
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(B, T, H, N, seed=0):
    """r, k, v ~ N/2, w = exp(-exp(N/2 - 2)) in (0, 1), u ~ 0.3 N,
    state0 ~ N/10, as f32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((B, T, H, N)) * 0.5).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, N)) * 0.5 - 2.0)
               ).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _both(arrays, dtype):
    """r, k, v, w in ``dtype``; u and state0 in f32 (as the model feeds
    them)."""
    jdt, tdt, _ = DTYPES[dtype]
    *rkvw, u, s0 = arrays
    j = [jnp.asarray(a, jdt) for a in rkvw] + [jnp.asarray(u),
                                               jnp.asarray(s0)]
    t = [torch.from_numpy(a).to(tdt) for a in rkvw] + [
        torch.from_numpy(u), torch.from_numpy(s0)]
    return j, t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_close(out, state, jout, jstate, tol):
    np.testing.assert_allclose(_f32(out), _f32(jout), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(state), _f32(jstate), atol=tol * 10,
                               rtol=tol * 10)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", WKV_SHAPES + RAGGED_SHAPES[:1])
def test_port_matches_jax_pallas_interpret(shape, dtype):
    j, t = _both(_inputs(*shape), dtype)
    jout, jstate = jops.rwkv6_wkv(*j, chunk=32, interpret=True)
    out, state = rwkv6_wkv(*t, chunk=32)
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    assert state.dtype == torch.float32 and state.shape == t[5].shape
    _assert_close(out, state, jout, jstate, DTYPES[dtype][2])


@pytest.mark.parametrize("shape", WKV_SHAPES[1:] + RAGGED_SHAPES)
def test_chunked_and_ref_match_jax(shape):
    """The plain version against ``wkv_chunked``, the port's step-by-step
    oracle against JAX's, in f32."""
    j, t = _both(_inputs(*shape, seed=1), "float32")
    for port, jax_fn in ((rwkv6_wkv_plain, jm.wkv_chunked),
                         (ref.wkv_ref, jref.wkv_ref)):
        out, state = port(*t)
        jout, jstate = jax_fn(*j)
        _assert_close(out, state, jout, jstate, 1e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_ragged_and_prime_T_match_step_by_step_ref(shape, dtype):
    """T = 100 runs in chunks of 50 and T = 97 in chunks of 1, as the JAX
    wrapper picks them; both match the step-by-step recurrence."""
    _, t = _both(_inputs(*shape, seed=2), dtype)
    out, state = rwkv6_wkv(*t)
    rout, rstate = ref.wkv_ref(*t)
    _assert_close(out, state, rout, rstate, DTYPES[dtype][2])


def _jax_chunk(T, chunk):
    """The chunk the JAX Pallas wrapper picks for T: T over its grid's
    sequential axis, read from the traced ``pallas_call``."""
    z = jnp.zeros((1, T, 1, 8))
    jaxpr = jax.make_jaxpr(functools.partial(jkernel.wkv, chunk=chunk,
                                             interpret=True))(
        z, z, z, z, jnp.zeros((1, 8)), jnp.zeros((1, 1, 8, 8)))
    calls = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert len(calls) == 1
    return T // calls[0].params["grid_mapping"].grid[1]


@pytest.mark.parametrize("T,chunk", [(512, 64), (100, 64), (97, 64),
                                     (30, 64), (96, 32), (1, 64)])
def test_pick_chunk_is_the_jax_wrappers_choice(T, chunk):
    assert pick_chunk(T, chunk) == _jax_chunk(T, chunk)


def test_decode_step_matches_jax():
    r, k, v, w, u, s0 = _inputs(2, 1, 3, 16, seed=3)
    args = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    out, state = tm.wkv_decode(*(torch.from_numpy(a) for a in args))
    jout, jstate = jm.wkv_decode(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(out.numpy(), _f32(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state.numpy(), _f32(jstate), atol=1e-5,
                               rtol=1e-5)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    _, t = _both(_inputs(2, 128, 3, 64, seed=4), "bfloat16")
    before = rwkv6_wkv.launches
    shapes_before = dict(rwkv6_wkv.shapes)
    out, state = rwkv6_wkv(*t)
    pout, pstate = rwkv6_wkv_plain(*t)
    assert torch.equal(out, pout) and torch.equal(state, pstate)
    # no kernel launch on the CPU
    assert rwkv6_wkv.launches == before
    assert dict(rwkv6_wkv.shapes) == shapes_before


@pytest.mark.parametrize("bad", ["dtype", "mixed", "u_dtype", "state_dtype",
                                 "u_shape", "state_shape", "rank", "strided",
                                 "head_size", "chunk", "device",
                                 "mixed_devices", "not_tensor"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, t = _both(_inputs(1, 32, 2, 16, seed=5), "float32")
    r, k, v, w, u, s0 = t
    kw = {}
    if bad == "dtype":
        r, k, v, w = r.half(), k.half(), v.half(), w.half()
    elif bad == "mixed":
        w = w.bfloat16()
    elif bad == "u_dtype":
        u = u.bfloat16()
    elif bad == "state_dtype":
        s0 = s0.double()
    elif bad == "u_shape":
        u = u[:1].contiguous()
    elif bad == "state_shape":
        s0 = s0[:, :, :8].contiguous()
    elif bad == "rank":
        r = r[0]
    elif bad == "strided":
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "head_size":
        r, k, v, w = (torch.zeros(1, 8, 1, 72) for _ in range(4))
        u, s0 = torch.zeros(1, 72), torch.zeros(1, 1, 72, 72)
    elif bad == "chunk":
        kw["chunk"] = 128
    elif bad == "device":
        r, k, v, w, u, s0 = (a.to("meta") for a in (r, k, v, w, u, s0))
    elif bad == "mixed_devices":
        s0 = s0.to("meta")
    else:
        r = r.numpy()
    with pytest.raises((TypeError, ValueError)):
        rwkv6_wkv(r, k, v, w, u, s0, **kw)
