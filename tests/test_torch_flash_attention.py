"""The port's flash attention against the JAX package.

Inputs come from numpy with a fixed seed and go through both packages. The
JAX kernel runs in Pallas interpret mode, as the JAX package's own tests
run it on the CPU, with equal q and kv blocks (its tile-index causal skip
is exact only then); the port's wrapper takes its plain version for CPU
tensors. At a ragged S and at unequal blocks the oracle is the naive
``attention_ref``. The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import attention as tattn

ATTN_SHAPES = [(1, 128, 1, 32), (2, 256, 4, 64), (1, 512, 2, 128),
               (2, 384, 3, 64), (1, 128, 2, 112)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_port_matches_jax_pallas_interpret(shape, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape), dtype)
    bq = 128 if shape[1] % 128 == 0 else 64
    expect = jops.flash_attention(jq, jk, jv, causal=True, interpret=True,
                                  block_q=bq, block_k=bq)
    got, _ = flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(expect), atol=tol, rtol=tol)


# head dims above 128: stablelm-12b's 160, 144, and 150 (not a multiple of
# 8); the JAX kernel takes the whole head dim in one block
WIDE_SHAPES = [(1, 128, 2, 144), (2, 128, 2, 150), (1, 256, 2, 160)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_wide_head_dims_match_jax(shape, dtype):
    """hd 144..160 against the JAX Pallas kernel (interpret mode, equal
    blocks) and the naive ``attention_ref``, out and lse."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape, seed=8), dtype)
    tol = DTYPES[dtype][2]
    got, lse = flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    expect = jops.flash_attention(jq, jk, jv, causal=True, interpret=True,
                                  block_q=128, block_k=128)
    np.testing.assert_allclose(_f32(got), _f32(expect), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(jref.attention_ref(jq, jk, jv)),
                               atol=tol, rtol=tol)
    if dtype == "float32":
        _, (_, _, _, _, jlse) = jfa._fwd_rule(jq, jk, jv, True, True, 128,
                                              128)
        np.testing.assert_allclose(lse.numpy(), _f32(jlse), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("shape", [(2, 256, 4, 64), (1, 128, 2, 112)])
def test_lse_matches_jax_kernel(shape):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape, seed=1), "float32")
    _, (_, _, _, _, jlse) = jfa._fwd_rule(jq, jk, jv, True, True, 64, 64)
    _, lse = flash_attention(tq, tk, tv)
    assert lse.shape == shape[:3] and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _f32(jlse), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 64), (64, 128),
                                    (48, 80), (32, 16)])
@pytest.mark.parametrize("S", [1, 100, 300])
def test_ragged_and_unequal_blocks_match_attention_ref(S, blocks):
    """Where the Pallas kernel is not the oracle (its skip is wrong for
    block_k < block_q, and it takes no ragged S): the position-derived
    skip and the short last tile against naive attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, S, 3, 112), seed=2))
    out, lse = flash_attention_plain(q, k, v, *blocks)
    np.testing.assert_allclose(out.numpy(), ref.attention_ref(q, k, v).numpy(),
                               atol=2e-5, rtol=2e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(112)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -torch.inf)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(s, -1).permute(0, 2, 1).numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_ref_matches_jax_oracle(dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, 96, 2, 32), seed=4), dtype)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(ref.attention_ref(tq, tk, tv)),
                               _f32(jref.attention_ref(jq, jk, jv)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", [64, 1024])
def test_reference_route_matches_jax_flash_reference(chunk):
    """The plain version run with the JAX reference's chunk (the whole
    sequence when the chunk exceeds it) is its ``flash_reference``; the
    naive oracles of the two packages agree too."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv((2, 256, 4, 64), seed=5),
                                       "float32")
    c = min(chunk, 256)
    np.testing.assert_allclose(
        flash_attention_plain(tq, tk, tv, c, c)[0].numpy(),
        _f32(jattn.flash_reference(jq, jk, jv, chunk)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        ref.attention_ref(tq, tk, tv).numpy(),
        _f32(jattn.naive_causal_attention(jq, jk, jv)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("length", [1, 17, 40])
def test_decode_attention_matches_jax(length):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    vc = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), length)
    expect = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(length))
    np.testing.assert_allclose(got.numpy(), _f32(expect), atol=2e-5,
                               rtol=2e-5)


def test_update_cache_writes_in_place_like_jax():
    rng = np.random.default_rng(7)
    kc, vc = (rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
              for _ in range(2))
    jk, jv = jattn.update_cache(*(jnp.asarray(a) for a in (kc, vc, kn, vn)),
                                jnp.asarray(5))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    k2, v2 = tattn.update_cache(tk, tv, torch.from_numpy(kn),
                                torch.from_numpy(vn), 5)
    assert k2 is tk and v2 is tv
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 100, 2, 112)))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v)
    pout, plse = flash_attention_plain(q, k, v)
    assert torch.equal(out, pout) and torch.equal(lse, plse)
    assert flash_attention.launches == before   # no kernel launch on the CPU


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "head_dim",
                                 "strided", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 16, 2, 32)))
    if bad == "dtype":
        q, k, v = (a.half() for a in (q, k, v))
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "shape":
        k = k[:, :8].contiguous()
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 16, 1, 168) for _ in range(3))
    elif bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        q, k, v = (a[0] for a in (q, k, v))
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v)
