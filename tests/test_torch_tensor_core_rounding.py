"""The rounding budget of the port's bf16 tensor-core kernels, on the CPU.

The bf16 routes of ``csrc/flash_attention.cu``, ``csrc/mamba2_ssd.cu``
and ``csrc/rwkv6_wkv.cu`` run their products on the tensor cores with
bf16 operands and f32 sums. Where an operand is f32 inside the kernel,
flash and SSD round it to bf16 first:

- flash: the probabilities P, as the A operand of P·V (the row sum l and
  the lse come from the unrounded f32 P);
- flash backward: Pᵀ as the A operand of dV += Pᵀ·dO, dSᵀ as that of
  dK += dSᵀ·Q, and dS as that of dQ += dS·K (S, dP, delta and the lse stay
  f32);
- SSD: the decay-masked scores (scores ∘ decay ∘ dt) before ·X, the
  carried state S before C·S (S itself stays f32; exp(cum) scales the f32
  product's rows), and B ∘ w before Bᵀ·X.

WKV splits each such operand into two bf16 parts instead, x = hi + lo with
lo = bf16(x − hi), and multiplies hi·hi + hi·lo + lo·hi (hi·v + lo·v where
the other operand is the exact bf16 v): r_dec, k_over, the strictly lower
scores (masked in f32) and the carried state S (its copy as the B operand
of r_dec·S; S stays f32). Its state update is exp(cum[c-1]) ∘ (S +
k_overᵀ·v), the same as exp(cum[c-1]) ∘ S + k_scaledᵀ·v. One rounding of
each operand, as flash and SSD do, misses the JAX bf16 tolerance where w
is near 1 and where cum reaches the −30 clamp; a test below shows it.

This file copies the port's plain versions with exactly those roundings
added (the emulation lives here, not in the port) and holds them against
the JAX package's oracles and its Pallas kernels in interpret mode, within
the JAX kernel tests' bf16 tolerances (2e-2 flash, 6e-2 SSD, WKV out 5e-2
and state 5e-1), at zamba2's widths (hd 112; P = N = 64, chunk 64,
T = 512) and rwkv6-3b's (N = 64, chunk 64, T = 512), at a small B·H.
The flash backward's rounding is held to its plain version within 1e-2,
the bf16 gate ``chip_smoke.py`` holds the kernel to, and to ``jax.grad``
of the JAX oracle (below, with its tolerance), at qwen2-vl-2b's training
head dim (128) and the widest ones (150, 160); never to the Pallas kernel
at unequal blocks (ROADMAP C5). Inputs come from numpy with a seed, drawn
as the JAX kernel tests draw them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.mamba2_ssd import pick_chunk
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_plain

FLASH_TOL, SSD_TOL, LSE_TOL = 2e-2, 6e-2, 2e-5
# The flash backward in bf16. Against its plain version (f32 products, one
# rounding of dq, dk, dv to bf16): 1e-2, the gate chip_smoke.py holds the
# kernel to. Against jax.grad of the JAX oracle on the same bf16 inputs:
# the JAX kernel tests hold f32 gradients at 5e-4 and have no bf16
# gradient case; a gradient rounded once to bf16 is already up to 2^-9 of
# |g| off (0.0078 at |g| = 4), which 5e-4 cannot hold, so the tolerance
# scales to the one those tests give a bf16 flash result, 2e-2.
BWD_TOL, JAX_BWD_TOL = 1e-2, 2e-2
WKV_TOL, WKV_STATE_TOL = 5e-2, 5e-1
NEG_INF = -1e30


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round an f32 tensor to bf16 (nearest even) and back to f32."""
    return t.to(torch.bfloat16).float()


def flash_rounded(q, k, v, block=64):
    """``flash_attention_plain`` with P rounded to bf16 as P·V's operand."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(B, S, H, hd)
    lse = torch.empty(B, S, H)
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        qpos = torch.arange(q0, q1)
        acc = torch.zeros(B, q1 - q0, H, hd)
        m = torch.full((B, q1 - q0, H), NEG_INF)
        l = torch.zeros(B, q1 - q0, H)
        for k0 in range(0, q1, block):
            k1 = min(k0 + block, S)
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, q0:q1],
                             kf[:, k0:k1]) * scale
            mask = qpos[:, None] >= torch.arange(k0, k1)[None, :]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1).permute(0, 2, 1))
            p = torch.exp(s - m_new.permute(0, 2, 1)[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1).permute(0, 2, 1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", _bf16(p), vf[:, k0:k1])
            m = m_new
        out[:, q0:q1] = acc / l[..., None]
        lse[:, q0:q1] = m + torch.log(l)
    return out.to(q.dtype), lse


def flash_bwd_rounded(q, k, v, out, lse, dout, block=64):
    """``flash_attention_bwd_plain`` with Pᵀ, dSᵀ and dS rounded to bf16 as
    the operands of dV += Pᵀ·dO, dK += dSᵀ·Q and dQ += dS·K."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    delta = (dof * out.float()).sum(-1)
    dq = torch.zeros(B, S, H, hd)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        qi, doi = qf[:, q0:q1], dof[:, q0:q1]
        lsei = lse[:, q0:q1].permute(0, 2, 1)[..., None]
        di = delta[:, q0:q1].permute(0, 2, 1)[..., None]
        qpos = torch.arange(q0, q1)
        for k0 in range(0, q1, block):
            k1 = min(k0 + block, S)
            kj, vj = kf[:, k0:k1], vf[:, k0:k1]
            mask = qpos[:, None] >= torch.arange(k0, k1)[None, :]
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kj) * scale
            p = torch.where(mask, torch.exp(s - lsei), torch.zeros_like(s))
            dp = torch.einsum("bqhd,bkhd->bhqk", doi, vj)
            ds = _bf16(p * (dp - di) * scale)
            dq[:, q0:q1] += torch.einsum("bhqk,bkhd->bqhd", ds, kj)
            dk[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", ds, qi)
            dv[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", _bf16(p), doi)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def ssd_rounded(x, dt, A, Bm, Cm, state0, chunk=64):
    """``mamba2_ssd_plain`` with the three f32 operands rounded to bf16."""
    Bsz, T, H, P = x.shape
    hpg = H // Bm.shape[2]
    c = pick_chunk(T, chunk)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = Bm.float().repeat_interleave(hpg, dim=2)
    Ch = Cm.float().repeat_interleave(hpg, dim=2)
    tri = torch.ones(c, c, dtype=torch.bool).tril()
    state = state0.float()
    ys = []
    for t0 in range(0, T, c):
        xt, dtt = xf[:, t0:t0 + c], dtf[:, t0:t0 + c]
        Bt, Ct = Bh[:, t0:t0 + c], Ch[:, t0:t0 + c]
        cum = torch.cumsum(dtt * Af[None, None], dim=1)
        y = torch.einsum("bthn,bhnp->bthp", Ct, _bf16(state)) \
            * torch.exp(cum)[..., None]
        sc = torch.einsum("bthn,bshn->bhts", Ct, Bt)
        decay = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None, :],
                                      max=0.0)).permute(0, 3, 1, 2)
        sc = sc * decay * dtt.permute(0, 2, 1)[:, :, None, :]
        sc = torch.where(tri, sc, torch.zeros_like(sc))
        ys.append(y + torch.einsum("bhts,bshp->bthp", _bf16(sc), xt))
        last = torch.exp(cum[:, -1])
        w_s = torch.exp(cum[:, -1:] - cum) * dtt
        state = state * last[..., None, None] + torch.einsum(
            "bshn,bshp->bhnp", _bf16(Bt * w_s[..., None]), xt)
    return torch.cat(ys, dim=1).to(x.dtype), state


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _ssd_inputs(B, T, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, T, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T, G, N)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, P)) * 0.1).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _ssd_both(arrays):
    """x, Bm, Cm in bf16, dt, A, state0 in f32, for JAX and for torch."""
    x, dt, A, Bm, Cm, s0 = arrays
    low = {0, 3, 4}
    j = [jnp.asarray(a, jnp.bfloat16 if i in low else jnp.float32)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(torch.bfloat16 if i in low
                                else torch.float32)
         for i, a in enumerate(arrays)]
    return j, t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("shape", [(1, 512, 2, 112), (2, 100, 1, 112),
                                   (1, 65, 2, 32)])
def test_flash_p_in_bf16_within_jax_bf16_tolerance(shape):
    """P rounded to bf16 against JAX's naive oracle: out within 2e-2, and
    the lse (from the unrounded P) equal to the plain version's within
    2e-5."""
    arrays = _qkv(shape, seed=21)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    out, lse = flash_rounded(q, k, v)
    expect = jref.attention_ref(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in arrays))
    np.testing.assert_allclose(_f32(out), _f32(expect), atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    _, plain_lse = flash_attention_plain(q, k, v)
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), atol=LSE_TOL,
                               rtol=LSE_TOL)


def test_flash_p_in_bf16_matches_pallas_interpret():
    arrays = _qkv((1, 128, 2, 112), seed=22)
    out, _ = flash_rounded(*(torch.from_numpy(a).bfloat16() for a in arrays))
    expect = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                    for a in arrays), causal=True,
                                  interpret=True, block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(out), _f32(expect), atol=FLASH_TOL,
                               rtol=FLASH_TOL)


# qwen2-vl-2b's training head dim, then the widest head dims at ragged S
BWD_SHAPES = [(1, 512, 2, 128), (1, 100, 2, 160), (2, 65, 3, 150)]


def _bwd_inputs(shape, seed=11):
    """q, k, v ~ N(0, 1) from one seed and dout from the next, in bf16, as
    ``chip_smoke.attention_inputs`` draws them; out and lse from the bf16
    forward's rounding (``flash_rounded``), as the card hands them over."""
    arrays = _qkv(shape, seed) + [_qkv(shape, seed + 1)[0]]
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in arrays)
    out, lse = flash_rounded(q, k, v)
    return arrays, (q, k, v, out, lse, dout)


def _excess(got, ref, tol):
    """max(|got - ref| - tol·|ref|): within atol = rtol = tol iff <= tol."""
    got, ref = _f32(got), _f32(ref)
    return float((np.abs(got - ref) - tol * np.abs(ref)).max())


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_bwd_bf16_operands_within_gate_of_plain(shape):
    """One bf16 rounding of Pᵀ, dSᵀ and dS keeps dq, dk and dv within the
    card's 1e-2 of the plain version; the rounding does show (the two
    differ), so no hi + lo split is needed."""
    _, args = _bwd_inputs(shape)
    got = flash_bwd_rounded(*args)
    want = flash_attention_bwd_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _excess(a, b, BWD_TOL) <= BWD_TOL
    assert any(not torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_bwd_bf16_operands_within_jax_grad_tolerance(shape):
    """The rounded backward against ``jax.vjp`` of the JAX oracle
    ``attention_ref`` on the same bf16 q, k, v and cotangent, within
    2e-2 (the reason is at ``JAX_BWD_TOL``)."""
    arrays, args = _bwd_inputs(shape)
    got = flash_bwd_rounded(*args)

    @jax.jit
    def grads(q, k, v, dout):
        _, vjp = jax.vjp(
            lambda a, b, c: jref.attention_ref(a, b, c, causal=True), q, k, v)
        return vjp(dout)

    for a, b in zip(got, grads(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in arrays))):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=JAX_BWD_TOL,
                                   rtol=JAX_BWD_TOL)


@pytest.mark.parametrize("shape", [(1, 512, 2, 64, 1, 64),
                                   (2, 100, 2, 64, 1, 64),
                                   (1, 128, 4, 32, 2, 16)])
def test_ssd_bf16_operands_within_jax_bf16_tolerance(shape):
    """The three f32 operands rounded to bf16 against JAX's step-by-step
    oracle: y and the final state within 6e-2."""
    j, t = _ssd_both(_ssd_inputs(*shape, seed=23))
    y, state = ssd_rounded(*t)
    jy, jstate = jref.ssd_ref(*j)
    np.testing.assert_allclose(_f32(y), _f32(jy), atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(state.numpy(), _f32(jstate), atol=SSD_TOL,
                               rtol=SSD_TOL)


def test_ssd_bf16_operands_match_pallas_interpret():
    j, t = _ssd_both(_ssd_inputs(1, 128, 2, 64, 1, 64, seed=24))
    y, state = ssd_rounded(*t)
    jy, jstate = jops.mamba2_ssd(*j, chunk=64, interpret=True)
    np.testing.assert_allclose(_f32(y), _f32(jy), atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(state.numpy(), _f32(jstate), atol=SSD_TOL,
                               rtol=SSD_TOL)


def _parts(x, split):
    """x as the kernel feeds it to the tensor cores: [bf16(x)], or with
    ``split`` [hi, lo] with lo = bf16(x - hi)."""
    hi = _bf16(x)
    return [hi, _bf16(x - hi)] if split else [hi]


def _product(eq, a, b):
    """Σ of the part products the kernel takes: all but lo·lo."""
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(a)
               for j, y in enumerate(b) if i + j < 2)


def wkv_rounded(r, k, v, w, u, state0, chunk=64, split=True):
    """``rwkv6_wkv_plain`` with the tensor-core route's operands: r_dec,
    k_over, the masked scores and the carried state, each split into bf16
    hi and lo (``split``) or rounded once to bf16; the state update as the
    kernel orders it, exp(cum[c-1]) ∘ (S + k_overᵀ·v)."""
    T = r.shape[1]
    c = pick_chunk(T, chunk)
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    strict = torch.ones(c, c, dtype=torch.bool).tril(-1)
    state = state0.float()
    outs = []
    for t0 in range(0, T, c):
        rt, kt, vt, wt = (a[:, t0:t0 + c] for a in (rf, kf, vf, wf))
        logw = torch.log(torch.clamp(wt, min=1e-8))
        cum = torch.clamp(torch.cumsum(logw, dim=1), min=-30.0)
        r_dec = _parts(rt * torch.exp(cum - logw), split)
        out = _product("bthn,bhnm->bthm", r_dec, _parts(state, split))
        k_over = _parts(kt * torch.exp(-cum), split)
        scores = _product("bthn,bshn->bhts", r_dec, k_over)
        scores = torch.where(strict, scores, torch.zeros_like(scores))
        diag = torch.einsum("bthn,bthn->bth", rt * uf[None, None], kt)
        out = out + _product("bhts,bshm->bthm", _parts(scores, split), [vt])
        outs.append(out + diag[..., None] * vt)
        p_last = torch.exp(cum[:, -1])
        state = (state + _product("bshn,bshm->bhnm", k_over, [vt])) \
            * p_last[..., None]
    return torch.cat(outs, dim=1).to(r.dtype), state


def _wkv_inputs(B, T, H, N, draw, seed):
    """r, k, v ~ N/2, u ~ 0.3 N, state0 ~ N/10, and w drawn three ways:
    as the JAX kernel test draws it (exp(-exp(N/2 - 2)), about 0.87);
    near 1 (0.99 to 0.999), as the served model's decays are; and small
    (exp(-exp(N/2)), about 0.37), so that cum reaches the -30 clamp inside
    a chunk of 64."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = f(B, T, H, N) * 0.5, f(B, T, H, N) * 0.5, f(B, T, H, N) * 0.5
    if draw == "jax":
        w = np.exp(-np.exp(f(B, T, H, N) * 0.5 - 2.0))
    elif draw == "near_one":
        w = rng.uniform(0.99, 0.999, (B, T, H, N))
    else:
        w = np.exp(-np.exp(f(B, T, H, N) * 0.5))
    u, s0 = f(H, N) * 0.3, f(B, H, N, N) * 0.1
    arrays = [a.astype(np.float32) for a in (r, k, v, w, u, s0)]
    j = [jnp.asarray(a, jnp.bfloat16 if i < 4 else jnp.float32)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(torch.bfloat16 if i < 4 else torch.float32)
         for i, a in enumerate(arrays)]
    return j, t


def _wkv_oracle(j, draw):
    """JAX's step-by-step oracle; where cum reaches the clamp, the Pallas
    kernel in interpret mode, since the clamped chunked form (which the
    Pallas kernel, the plain version and the CUDA kernels compute) then
    departs from the unclamped recurrence by design."""
    if draw == "clamp":
        return jops.rwkv6_wkv(*j, chunk=64, interpret=True)
    return jref.wkv_ref(*j)


WKV_DRAWS = ["jax", "near_one", "clamp"]


@pytest.mark.parametrize("draw", WKV_DRAWS)
def test_wkv_split_operands_within_jax_bf16_tolerance(draw):
    """The split operands against JAX's oracle at rwkv6-3b's widths: out
    within 5e-2 and the final state within 5e-1, for all three draws."""
    j, t = _wkv_inputs(1, 512, 2, 64, draw, seed=25)
    out, state = wkv_rounded(*t)
    jout, jstate = _wkv_oracle(j, draw)
    np.testing.assert_allclose(_f32(out), _f32(jout), atol=WKV_TOL,
                               rtol=WKV_TOL)
    np.testing.assert_allclose(state.numpy(), _f32(jstate),
                               atol=WKV_STATE_TOL, rtol=WKV_STATE_TOL)


@pytest.mark.parametrize("draw", WKV_DRAWS)
def test_wkv_split_operands_match_pallas_interpret(draw):
    j, t = _wkv_inputs(1, 512, 2, 64, draw, seed=26)
    out, state = wkv_rounded(*t)
    jout, jstate = jops.rwkv6_wkv(*j, chunk=64, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(jout), atol=WKV_TOL,
                               rtol=WKV_TOL)
    np.testing.assert_allclose(state.numpy(), _f32(jstate),
                               atol=WKV_STATE_TOL, rtol=WKV_STATE_TOL)


@pytest.mark.parametrize("draw", WKV_DRAWS)
def test_wkv_split_operands_close_to_plain(draw):
    """The split keeps about 16 bits of each operand: the emulation stays
    within one bf16 step of the output of the plain version, far inside
    the tolerance, and its state within 1e-3."""
    _, t = _wkv_inputs(1, 512, 2, 64, draw, seed=27)
    out, state = wkv_rounded(*t)
    pout, pstate = rwkv6_wkv_plain(*t)
    step = 2.0 ** -7 * np.maximum(np.abs(_f32(pout)), 1.0)
    assert (np.abs(_f32(out) - _f32(pout)) <= step).all()
    np.testing.assert_allclose(state.numpy(), pstate.numpy(), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("draw", ["near_one", "clamp"])
def test_wkv_single_bf16_rounding_misses_jax_tolerance(draw):
    """Why the route splits its operands: one bf16 rounding of each, as
    the flash and SSD kernels do, takes the output past 5e-2 + 5e-2·|ref|
    where w is near 1 and where cum reaches the clamp."""
    j, t = _wkv_inputs(1, 512, 2, 64, draw, seed=25)
    out, _ = wkv_rounded(*t, split=False)
    jout, _ = _wkv_oracle(j, draw)
    excess = np.abs(_f32(out) - _f32(jout)) - WKV_TOL * np.abs(_f32(jout))
    assert excess.max() > WKV_TOL
