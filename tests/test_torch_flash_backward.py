"""The port's flash-attention backward on the CPU against JAX's gradients.

``flash_attention`` records an ``autograd.Function`` when an input
requires grad; on CPU tensors its forward is ``flash_attention_plain`` and
its backward ``flash_attention_bwd_plain`` (the plain versions of the two
CUDA kernels). Its gradients are held to ``jax.grad`` through the JAX
package's ``flash_reference`` (custom VJP: ``_flash_bwd_impl``) and
through the quadratic ``kernels.ref.attention_ref``, at 5e-4, the JAX
kernel tests' gradient tolerance (``tests/test_kernels.py``). Inputs are
drawn with numpy from fixed seeds. The sequence lengths include the 64-row
tile's edges (1, 63, 65) and a ragged 100; the head dims 150 and 160 are
the widest the kernels take; GQA runs through ``attn_block`` of both
models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import transformer as jtf
from repro.models.attention import flash_reference
from repro.models.config import get_config as jconfig
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import transformer as ttf
from repro_torch.models.config import get_config as tconfig
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=5e-4, rtol=5e-4)

SHAPES = [(1, 128, 2, 32),                       # tests/test_kernels.py:37
          (2, 1, 2, 32), (2, 63, 3, 32), (2, 65, 3, 32), (1, 100, 2, 64),
          (1, 100, 2, 150), (2, 65, 2, 160), (1, 128, 1, 160)]


def draw(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def port_grads(q, k, v, g):
    """(out, dq, dk, dv) of the port, for the loss sum(out * g)."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = tfa.flash_attention(tq, tk, tv)
    assert out.grad_fn is not None and not lse.requires_grad
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    return [out.detach().numpy()] + [a.numpy() for a in grads]


def jax_grads(fn, q, k, v, g):
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(g))
    return [np.asarray(a) for a in run(*map(jnp.asarray, (q, k, v, g)))]


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax_reference_and_oracle(shape):
    q, k, v, g = draw(shape, seed=sum(shape))
    got = port_grads(q, k, v, g)
    with jax.default_matmul_precision("highest"):
        for fn in (lambda a, b, c: flash_reference(a, b, c, 64),
                   lambda a, b, c: ref.attention_ref(a, b, c, causal=True)):
            for a, b in zip(got, jax_grads(fn, q, k, v, g)):
                np.testing.assert_allclose(a, b, **TOL)


def test_backward_plain_is_the_functions_backward():
    """``flash_attention_bwd`` on CPU tensors is the plain version, and the
    Function hands it the forward's out and lse: the same numbers."""
    q, k, v, g = (torch.from_numpy(a) for a in draw((2, 70, 3, 48), 5))
    out, lse = tfa.flash_attention_plain(q, k, v)
    direct = tfa.flash_attention_bwd(q, k, v, out, lse, g)
    plain = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g)
    for a, b in zip(direct, plain):
        assert torch.equal(a, b)
    via = port_grads(q.numpy(), k.numpy(), v.numpy(), g.numpy())[1:]
    for a, b in zip(via, plain):
        np.testing.assert_array_equal(a, b.numpy())


def test_backward_tiles_do_not_change_the_result():
    """The plain backward's tile sizes (q 32 and kv 16 against 64 and 64)
    agree: the causal mask comes from token positions, not tile
    indices."""
    q, k, v, g = (torch.from_numpy(a) for a in draw((1, 100, 2, 32), 9))
    out, lse = tfa.flash_attention_plain(q, k, v)
    a = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g)
    b = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, block_q=32,
                                      block_k=16)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)


def test_backward_bf16_keeps_dtype():
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in
                  draw((1, 65, 2, 32), 3))
    out, lse = tfa.flash_attention_plain(q, k, v)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, g)
    ref32 = tfa.flash_attention_bwd(q.float(), k.float(), v.float(),
                                    out.float(), lse, g.float())
    for a, b in zip(grads, ref32):
        assert a.dtype == torch.bfloat16
        # one bf16 rounding of each f32 sum (2^-8 relative), and out
        # rounded to bf16 before delta in one of the two
        torch.testing.assert_close(a.float(), b, atol=2e-2, rtol=2e-2)


def test_backward_checks_its_inputs():
    q, k, v, g = (torch.from_numpy(a) for a in draw((1, 8, 2, 16), 1))
    out, lse = tfa.flash_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, k, v, out, lse[:, :4], g)
    with pytest.raises(ValueError, match="dout"):
        tfa.flash_attention_bwd(q, k, v, out, lse, g.bfloat16())
    with pytest.raises(ValueError, match="head dims"):
        big = torch.zeros(1, 2, 1, 161)
        tfa.flash_attention_bwd(big, big, big, big, torch.zeros(1, 2, 1),
                                big)


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2-vl-2b"])
def test_gqa_attn_block_grads_match_jax(arch, monkeypatch):
    """Grouped-query attention through ``attn_block`` in f32 (the kv heads
    repeated to the query heads before the kernel): the gradients of the
    block's parameters and input against JAX's reference route."""
    monkeypatch.setattr(jtf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(ttf, "COMPUTE_DTYPE", torch.float32)
    jcfg, tcfg = jconfig(arch, smoke=True), tconfig(arch, smoke=True)
    assert tcfg.n_heads > tcfg.n_kv_heads
    rng = np.random.default_rng(6)
    D, hd = jcfg.d_model, jcfg.resolved_head_dim
    Hq, Hkv = jcfg.n_heads, jcfg.n_kv_heads
    p_np = {name: (rng.standard_normal(shape) / np.sqrt(shape[0])
                   ).astype(np.float32)
            for name, shape in (("wq", (D, Hq * hd)), ("wk", (D, Hkv * hd)),
                                ("wv", (D, Hkv * hd)), ("wo", (Hq * hd, D)))}
    Bn, Sn = 2, 65
    x = rng.standard_normal((Bn, Sn, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((Bn, Sn, jcfg.d_model)).astype(np.float32)
    if jcfg.rope_variant == "mrope":
        pos = rng.integers(0, 4 * Sn, (Bn, 3, Sn)).astype(np.int32)
    else:
        pos = np.broadcast_to(np.arange(Sn, dtype=np.int32),
                              (Bn, Sn)).copy()

    def jfn(p, xx):
        return jtf.attn_block(p, xx, jcfg, jnp.asarray(pos), False)[0]

    @jax.jit
    def jrun(p, xx, gg):
        out, vjp = jax.vjp(jfn, p, xx)
        return (out, *vjp(gg))

    with jax.default_matmul_precision("highest"):
        jout, jgp, jgx = jrun(jax.tree.map(jnp.asarray, p_np),
                              jnp.asarray(x), jnp.asarray(g))
    tp = params_from_numpy(p_np, "cpu")
    for t in tp.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, _ = ttf.attn_block(tp, tx, tcfg, torch.from_numpy(pos), False)
    names = sorted(tp)
    grads = torch.autograd.grad(tout, [tp[n] for n in names] + [tx],
                                torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    for name, got in zip(names, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(jgp[name]),
                                   **TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **TOL)
