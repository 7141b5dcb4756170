"""Flash attention without the causal mask (``causal=False``): the port
against the JAX package on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.
Every case runs in f32 and bf16, at S = 64 and a ragged S = 300, at head
dims 64 and 160, with equal and unequal q and kv blocks. The JAX kernel
runs in Pallas interpret mode (its ``causal=False`` forward runs every kv
block, unmasked); the port's wrapper takes its plain version for CPU
tensors, and the plain version also runs at the JAX blocks.

The JAX kernel's ``custom_vjp`` backward applies the causal mask whatever
``causal`` is (ROADMAP.md C15), so the port's backward is held to
``jax.grad`` of the quadratic ``attention_ref(causal=False)`` instead:
at 5e-4 in f32 (``tests/test_kernels.py``'s gradient tolerance) and, in
bf16, at the bf16 tolerance of 2e-2 (the port rounds each f32 sum of dq,
dk, dv once to bf16, and out before delta). The CUDA kernels are held to
the plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import costs, ref
from repro_torch.kernels import flash_attention as tfa

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
SEQS = (64, 300)
HEAD_DIMS = (64, 160)
# (block_q, block_k) by S: equal and unequal, each dividing S (the JAX
# kernel asks for it)
BLOCKS = {64: {"equal": (32, 32), "unequal": (32, 16)},
          300: {"equal": (100, 100), "unequal": (60, 150)}}
CASES = [(dt, S, hd, kind) for dt in sorted(DTYPES) for S in SEQS
         for hd in HEAD_DIMS for kind in ("equal", "unequal")]


def draw(S, hd, n=4, seed=0):
    rng = np.random.default_rng((seed, S, hd))
    return [rng.standard_normal((1, S, 2, hd)).astype(np.float32)
            for _ in range(n)]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_attention_ref_matches_jax(dtype, S, hd):
    (jq, jk, jv), (tq, tk, tv) = _both(draw(S, hd, 3), dtype)
    want = jref.attention_ref(jq, jk, jv, causal=False)
    got = ref.attention_ref(tq, tk, tv, causal=False)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    # and it is not the causal function
    assert not np.allclose(_f32(got), _f32(ref.attention_ref(tq, tk, tv)),
                           atol=1e-2)


@pytest.mark.parametrize("dtype,S,hd,blocks", CASES)
def test_forward_matches_jax_pallas_interpret(dtype, S, hd, blocks):
    (jq, jk, jv), (tq, tk, tv) = _both(draw(S, hd, 3), dtype)
    bq, bk = BLOCKS[S][blocks]
    want, (*_, want_lse) = jfa._fwd_rule(jq, jk, jv, False, True, bq, bk)
    tol = DTYPES[dtype][2]
    for out, lse in (tfa.flash_attention(tq, tk, tv, causal=False),
                     tfa.flash_attention_plain(tq, tk, tv, bq, bk,
                                               causal=False)):
        assert out.dtype == tq.dtype and lse.dtype == torch.float32
        np.testing.assert_allclose(_f32(out), _f32(want), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(_f32(lse), _f32(want_lse), atol=2e-5,
                                   rtol=2e-5)


def _port_grads(arrays, dtype, blocks=None):
    """(out, dq, dk, dv) of the port for the loss sum(out * g): through
    the public function's autograd, or the plain backward at ``blocks``."""
    tdt = DTYPES[dtype][1]
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in arrays)
    if blocks is None:
        leaves = [a.requires_grad_(True) for a in (q, k, v)]
        out, lse = tfa.flash_attention(*leaves, causal=False)
        assert out.grad_fn is not None and not lse.requires_grad
        return [out] + list(torch.autograd.grad(out, leaves, g))
    out, lse = tfa.flash_attention_plain(q, k, v, *blocks, causal=False)
    return [out] + list(tfa.flash_attention_bwd_plain(
        q, k, v, out, lse, g, *blocks, causal=False))


@pytest.mark.parametrize("dtype,S,hd,blocks", CASES)
def test_backward_matches_jax_grad_of_reference(dtype, S, hd, blocks):
    arrays = draw(S, hd)
    tdt = DTYPES[dtype][1]
    # the bf16 inputs' exact values, differentiated in f32
    exact = [torch.from_numpy(a).to(tdt).float().numpy() for a in arrays]

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(
            a, b, c, causal=False), q, k, v)
        return (out, *vjp(g))

    with jax.default_matmul_precision("highest"):
        want = [np.asarray(a) for a in run(*map(jnp.asarray, exact))]
    tol = GRAD_TOL[dtype]
    for got in (_port_grads(arrays, dtype),
                _port_grads(arrays, dtype, BLOCKS[S][blocks])):
        assert all(a.dtype == tdt for a in got)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_f32(a), b, atol=tol, rtol=tol)


def test_jax_pallas_backward_ignores_causal_false():
    """ROADMAP.md C15, pinned: ``jax.grad`` through the JAX kernel with
    ``causal=False`` is the causal mask's gradient, far from the true
    one. (The port is never held to it.)"""
    q, k, v = (jnp.asarray(a) for a in draw(64, 16, 3))

    def loss(fn):
        return lambda a, b, c: (fn(a, b, c) ** 2).sum()

    pallas = jax.grad(loss(lambda a, b, c: jfa.flash_attention(
        a, b, c, False, True, 32, 32)), (0, 1, 2))(q, k, v)
    true = jax.grad(loss(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=False)), (0, 1, 2))(q, k, v)
    gap = max(float(jnp.abs(a - b).max()) for a, b in zip(pallas, true))
    assert gap > 0.1
    tq, tk, tv = (torch.from_numpy(np.array(a)).requires_grad_(True)
                  for a in (q, k, v))
    out, _ = tfa.flash_attention(tq, tk, tv, causal=False)
    port = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for a, b in zip(port, true):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=5e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S", (1, 65, 300))
def test_causal_true_is_bit_equal_to_the_default(dtype, S):
    tdt = DTYPES[dtype][1]
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in draw(S, 64))
    default = tfa.flash_attention(q, k, v)
    explicit = tfa.flash_attention(q, k, v, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(default, explicit))
    out, lse = default
    bwd = tfa.flash_attention_bwd(q, k, v, out, lse, g)
    bwd_explicit = tfa.flash_attention_bwd(q, k, v, out, lse, g,
                                           causal=True)
    assert all(torch.equal(a, b) for a, b in zip(bwd, bwd_explicit))
    # the full mode differs from the causal one (but at S = 1)
    full = tfa.flash_attention(q, k, v, causal=False)[0]
    assert torch.equal(full, out) == (S == 1)


@pytest.mark.parametrize("S", (1, 300))
def test_full_mode_masks_only_past_s(S):
    """S = 1 and a ragged last tile: rows past S are never read; the
    plain version at any blocks gives the reference's values."""
    q, k, v = (torch.from_numpy(a) for a in draw(S, 32, 3))
    want = ref.attention_ref(q, k, v, causal=False)
    for bq, bk in ((64, 64), (7, 64), (64, 13)):
        out, lse = tfa.flash_attention_plain(q, k, v, bq, bk, causal=False)
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
        s = torch.einsum("bqhd,bkhd->bqhk", q, k) / np.sqrt(32)
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("causal", (True, False))
def test_op_fake_and_flop_formula_count_the_modes_work(causal):
    """On fake tensors the op computes nothing and counts no launch; its
    FLOP formula (forward and backward) counts S(S+1)/2 (q, k) pairs a
    (b, h) when causal and S^2 without the mask: about twice the work."""
    B, S, H, hd = 2, 64, 4, 32
    fake = FakeTensorMode()
    with fake:
        leaves = [torch.empty(B, S, H, hd, dtype=torch.bfloat16,
                              requires_grad=True) for _ in range(3)]
    before = (tfa.flash_attention.launches,
              tfa.flash_attention_bwd.launches)
    counter = FlopCounterMode(display=False)
    with fake, counter:
        out, lse = tfa.flash_attention(*leaves, causal=causal)
        out.float().sum().backward()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == before
    assert tuple(out.shape) == (B, S, H, hd) and lse.dtype == torch.float32
    pairs = S * (S + 1) / 2 if causal else S * S
    fwd = 4 * B * H * hd * pairs
    bwd = 10 * B * H * hd * pairs
    assert counter.get_total_flops() >= int(fwd) + int(bwd)
    counts = counter.get_flop_counts()["Global"]
    assert counts[torch.ops.repro_torch.flash_fwd] == int(fwd)
    assert counts[torch.ops.repro_torch.flash_bwd] == int(bwd)
    causal_fwd = costs.flash_bound((B, S, H, hd), 2)["flops"]
    full_fwd = costs.flash_bound((B, S, H, hd), 2, causal=False)["flops"]
    assert full_fwd / causal_fwd == 2 * S / (S + 1)
    assert costs.op_cost("flash_fwd", (*leaves, causal))["flops"] == fwd
    assert costs.op_cost("flash_bwd", (*leaves, out, lse, out,
                                       causal))["flops"] == bwd
