"""The rounding budget of the SSD and WKV backward kernels' bf16 routes, on
the CPU.

The bf16 routes of ``csrc/mamba2_ssd_bwd.cu`` and ``csrc/rwkv6_wkv_bwd.cu``
split the work by chunk: each chunk's increments of the state and of its
gradient (products over the chunk), the state passing across chunks in f32
(S_{k+1} = e^{cum_L} S_k + ΔS_k forwards, dS'_{k-1} = e^{cum_L} dS'_k +
ΔdS_k backwards), then every chunk's gradient from its own S_k and dS'_k.
Their products run on the tensor cores with bf16 operands and f32 sums.
Products of two bf16 inputs are exact (SSD's C·Bᵀ and dy·xᵀ, WKV's
dout·vᵀ). Every other operand is f32 inside the kernel and is split into
two bf16 parts, x = hi + lo with lo = bf16(x − hi), about 16 bits of x:

- SSD: B ∘ w and C ∘ e^{cum} (the increments), S and dS' (the readout's
  and the state update's terms), M = (C·Bᵀ) ∘ D ∘ dt and dG = (dy·xᵀ) ∘ D
  ∘ dt. Each meets an exact bf16 input, so a product takes two mma
  (hi·b + lo·b). One rounding of each, as the SSD forward does, takes dx,
  dB and dC past the card's 1e-2 gate (a test below shows it), and leaving
  any one of them rounded once misses too.
- WKV: r_dec, k_over, k_scaled, the strictly lower scores and dout·vᵀ
  (masked in f32), S and dS'. A product of two split operands takes three
  mma (hi·hi + hi·lo + lo·hi), one with an exact bf16 input two. One
  rounding misses by far (ROADMAP C4; a test below shows it).

Q (dy·xᵀ ∘ M), its spanned prefix sums and every per-step vector stay f32,
as the kernels keep them. This file writes the two backwards chunk-parallel
with exactly those operands (the emulation lives here, not in the port) and
holds them to the plain versions within 1e-2, the gate ``chip_smoke.py``
and ``tests/test_torch_gpu.py`` hold the kernels to, and to ``jax.grad`` of
``repro.models.mamba2.ssd_chunked`` / ``repro.models.rwkv6.wkv_chunked``
within the bf16 tolerances of ``tests/test_torch_*_backward.py`` (6e-2
SSD, 5e-2 WKV), at zamba2's widths (P = N = 64, chunk 64, T = 512) and
rwkv6-3b's (N = 64), at small B·H, WKV also where the cumsum passes −30 and
w = 1e-9. Without rounding, the chunk-parallel form is the plain backward
in f64 within 1e-10. Inputs come from numpy with a seed, drawn as the
card checks draw them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_bwd_plain, pick_chunk
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_bwd_plain

GATE = 1e-2           # the card's bf16 gate against the plain version
SSD_JAX_TOL, WKV_JAX_TOL = 6e-2, 5e-2
NORMWISE = 1e-10                # f64, no rounding
SSD_NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dstate0")
WKV_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round an f32 tensor to bf16 (nearest even) and back to f32."""
    return t.to(torch.bfloat16).float()


def _parts(x: torch.Tensor, mode: str) -> list:
    """x as a kernel feeds it to the tensor cores: ``split`` [hi, lo] with
    lo = bf16(x - hi), ``round`` [bf16(x)], ``exact`` [x] (no rounding)."""
    if mode == "exact":
        return [x]
    hi = _bf16(x)
    return [hi, _bf16(x - hi)] if mode == "split" else [hi]


def _product(eq: str, a: list, b: list) -> torch.Tensor:
    """Σ of the part products a kernel takes: all but lo·lo."""
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(a)
               for j, y in enumerate(b) if i + j < 2)


def ssd_bwd_rounded(x, dt, A, Bm, Cm, state0, dy, dstate_T=None, chunk=64,
                    mode="split"):
    """``mamba2_ssd_bwd_plain`` chunk-parallel, as the bf16 route computes
    it: the increments (B ∘ w)ᵀ·x and (C ∘ e^{cum})ᵀ·dy, the f32 state
    passing, then each chunk's gradient from its S and dS', with B ∘ w,
    C ∘ e^{cum}, S, dS', M and dG as ``_parts(·, mode)``. f64 inputs stay
    f64."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    c = pick_chunk(T, chunk)
    K = T // c
    wt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dtf, Af, dyf = (a.to(wt) for a in (x, dt, A, dy))
    Bh = Bm.to(wt).repeat_interleave(hpg, dim=2)
    Ch = Cm.to(wt).repeat_interleave(hpg, dim=2)

    def chunks(a):
        return a.reshape(Bsz, K, c, *a.shape[2:])

    xk, dtk, dyk, Bk, Ck = (chunks(a) for a in (xf, dtf, dyf, Bh, Ch))
    op = functools.partial(_parts, mode=mode)
    cum = torch.cumsum(dtk * Af, dim=2)                   # (B, K, c, H)
    ecum = torch.exp(cum)
    last = ecum[:, :, -1]                                 # (B, K, H)
    dec = torch.exp(cum[:, :, -1:] - cum)
    w = dec * dtk
    inc = _product("bkshn,bkshp->bkhnp", op(Bk * w[..., None]), [xk])
    dinc = _product("bkthn,bkthp->bkhnp", op(Ck * ecum[..., None]), [dyk])
    S = [state0.to(wt)]
    for k in range(K - 1):
        S.append(last[:, k, :, None, None] * S[-1] + inc[:, k])
    grad = (torch.zeros_like(S[0]) if dstate_T is None
            else dstate_T.to(wt))
    dSp = [None] * K
    for k in reversed(range(K)):
        dSp[k] = grad
        grad = last[:, k, :, None, None] * grad + dinc[:, k]
    S, dSp = torch.stack(S, 1), torch.stack(dSp, 1)      # (B, K, H, N, P)
    tri = torch.ones(c, c, dtype=torch.bool).tril()
    Gm = torch.einsum("bkthn,bkshn->bkhts", Ck, Bk)
    dM = torch.einsum("bkthp,bkshp->bkhts", dyk, xk)
    diff = (cum[:, :, :, None] - cum[:, :, None, :]).permute(0, 1, 4, 2, 3)
    D = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)),
                    torch.zeros_like(diff))
    dts = dtk.permute(0, 1, 3, 2)[:, :, :, None, :]
    M, dG = Gm * D * dts, dM * D * dts
    Q = torch.where(tri.tril(-1) & (diff <= 0.0), dM * M,
                    torch.zeros_like(M))
    cole = (dM * Gm * D).sum(3).permute(0, 1, 3, 2)
    sdy = _product("bkhnp,bkthp->bkthn", op(S), [dyk])
    sdx = _product("bkhnp,bkshp->bkshn", op(dSp), [xk])
    dC = ecum[..., None] * sdy + _product("bkhts,bkshn->bkthn", op(dG), [Bk])
    dB = w[..., None] * sdx + _product("bkhts,bkthn->bkshn", op(dG), [Ck])
    dx = (_product("bkhts,bkthp->bkshp", op(M), [dyk]) + w[..., None]
          * _product("bkhnp,bkshn->bkshp", op(dSp), [Bk]))
    dW = (Bk * sdx).sum(-1)
    U = F.pad(torch.cumsum(Q, 4)[..., :-1], (1, 0))
    dloga = ((U * tri.to(U.dtype)).sum(3).permute(0, 1, 3, 2)
             + torch.flip(torch.cumsum(torch.flip(ecum * (Ck * sdy).sum(-1),
                                                  [2]), 2), [2])
             + F.pad(torch.cumsum(dW * w, 2)[:, :, :-1], (0, 0, 1, 0))
             + (last * (S * dSp).sum((3, 4)))[:, :, None])
    ddt = cole + dec * dW + Af * dloga
    dA = (dtk * dloga).sum((0, 1, 2))

    def whole(a):
        return a.reshape(Bsz, T, *a.shape[3:])

    dBm = whole(dB).reshape(Bsz, T, G, hpg, N).sum(3)
    dCm = whole(dC).reshape(Bsz, T, G, hpg, N).sum(3)
    return (whole(dx).to(x.dtype), whole(ddt), dA, dBm.to(Bm.dtype),
            dCm.to(Cm.dtype), grad)


def wkv_bwd_rounded(r, k, v, w, u, state0, dout, dstate_T=None, chunk=64,
                    mode="split"):
    """``rwkv6_wkv_bwd_plain`` chunk-parallel, as the bf16 route computes
    it: the increments k_scaledᵀ·v and r_decᵀ·dout, the f32 state passing,
    then each chunk's gradient from its S and dS', with r_dec, k_over,
    k_scaled, the scores, dout·vᵀ, S and dS' as ``_parts(·, mode)``. f64
    inputs stay f64."""
    Bsz, T, H, N = r.shape
    c = pick_chunk(T, chunk)
    K = T // c
    wt = torch.float64 if r.dtype == torch.float64 else torch.float32

    def chunks(a):
        return a.to(wt).reshape(Bsz, K, c, H, N)

    rk, kk, vk, wk, dok = (chunks(a) for a in (r, k, v, w, dout))
    uf = u.to(wt)
    op = functools.partial(_parts, mode=mode)
    wc = torch.clamp(wk, min=1e-8)
    logw = torch.log(wc)
    raw = torch.cumsum(logw, 2)
    cum = torch.clamp(raw, min=-30.0)
    e1, en = torch.exp(cum - logw), torch.exp(-cum)
    decay = torch.exp(cum[:, :, -1:] - cum)
    r_dec, k_over, k_scaled = rk * e1, kk * en, kk * decay
    p_last = torch.exp(cum[:, :, -1])                     # (B, K, H, N)
    rd, ko, ks = op(r_dec), op(k_over), op(k_scaled)
    inc = _product("bkshn,bkshm->bkhnm", ks, [vk])
    dinc = _product("bkthn,bkthm->bkhnm", rd, [dok])
    S = [state0.to(wt)]
    for j in range(K - 1):
        S.append(S[-1] * p_last[:, j, :, :, None] + inc[:, j])
    grad = (torch.zeros_like(S[0]) if dstate_T is None
            else dstate_T.to(wt))
    dSp = [None] * K
    for j in reversed(range(K)):
        dSp[j] = grad
        grad = grad * p_last[:, j, :, :, None] + dinc[:, j]
    S, dSp = torch.stack(S, 1), torch.stack(dSp, 1)      # (B, K, H, N, N)
    strict = torch.ones(c, c, dtype=torch.bool).tril(-1)
    scores = _product("bkthn,bkshn->bkhts", rd, ko)
    scores = torch.where(strict, scores, torch.zeros_like(scores))
    dsc = torch.einsum("bkthm,bkshm->bkhts", dok, vk)
    dsc = op(torch.where(strict, dsc, torch.zeros_like(dsc)))
    diag = (rk * uf * kk).sum(-1)
    ddiag = (dok * vk).sum(-1)
    dr_dec = (_product("bkhnm,bkthm->bkthn", op(S), [dok])
              + _product("bkhts,bkshn->bkthn", dsc, ko))
    dk_over = _product("bkhts,bkthn->bkshn", dsc, rd)
    dk_scaled = _product("bkhnm,bkshm->bkshn", op(dSp), [vk])
    dv = (_product("bkhts,bkthm->bkshm", op(scores), [dok])
          + diag[..., None] * dok
          + _product("bkshn,bkhnm->bkshm", ks, op(dSp)))
    bonus = ddiag[..., None] * uf
    dr = dr_dec * e1 + bonus * kk
    dk = dk_over * en + dk_scaled * decay + bonus * rk
    du = torch.einsum("bkth,bkthn->hn", ddiag, rk * kk)
    ek = dk_scaled * k_scaled
    dcum = dr_dec * r_dec - dk_over * k_over - ek
    dcum[:, :, -1] += ek.sum(2) + p_last * (S * dSp).sum(-1)
    draw = torch.where(raw >= -30.0, dcum, torch.zeros_like(dcum))
    dlogw = (torch.flip(torch.cumsum(torch.flip(draw, [2]), 2), [2])
             - dr_dec * r_dec)
    dw = torch.where(wk >= 1e-8, dlogw / wc, torch.zeros_like(dlogw))

    def whole(a):
        return a.reshape(Bsz, T, H, N).to(r.dtype)

    return whole(dr), whole(dk), whole(dv), whole(dw), du, grad


def _ssd_arrays(B, T, H, P, G, N, seed):
    """x, dt = softplus(N), A = -exp(N/2), B and C ~ N/2, state0 ~ N/10,
    dy ~ N, dstate_T ~ N, as f32 numpy (dy rounded to bf16, as the train
    step hands it over)."""
    rng = np.random.default_rng(seed)

    def draw(*s):
        return rng.standard_normal(s).astype(np.float32)

    arrays = [draw(B, T, H, P), np.log1p(np.exp(draw(B, T, H))),
              -np.exp(draw(H) * 0.5), draw(B, T, G, N) * 0.5,
              draw(B, T, G, N) * 0.5, draw(B, H, N, P) * 0.1,
              draw(B, T, H, P), draw(B, H, N, P)]
    for i in (0, 3, 4, 6):
        arrays[i] = _bf16(torch.from_numpy(arrays[i])).numpy()
    return [np.ascontiguousarray(a, np.float32) for a in arrays]


def _wkv_arrays(B, T, H, N, seed, clamped=False):
    """r, k, v ~ N/2, w = exp(-exp(N/2 - 2)), u ~ 0.3 N, state0 ~ N/10,
    dout ~ N, dstate_T ~ N, as f32 numpy (the bf16 inputs rounded).
    ``clamped``, as ``chip_smoke.scan_bwd_inputs`` draws it: a quarter of
    the channels decay by e^-0.5..e^-3 a step, so the cumsum passes -30
    inside a chunk, and channel N/2 has w = 1e-9 at the 10th step of each
    chunk."""
    rng = np.random.default_rng(seed)

    def draw(*s):
        return rng.standard_normal(s).astype(np.float32)

    r, k, v = (draw(B, T, H, N) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(draw(B, T, H, N) * 0.5 - 2.0))
    if clamped:
        q = max(1, N // 4)
        w[..., :q] = np.exp(-rng.uniform(0.5, 3.0, (B, T, H, q)))
        w[:, 9::pick_chunk(T), :, N // 2] = 1e-9
    arrays = [r, k, v, w, draw(H, N) * 0.3, draw(B, H, N, N) * 0.1,
              draw(B, T, H, N), draw(B, H, N, N)]
    for i in (0, 1, 2, 3, 6):
        arrays[i] = _bf16(torch.from_numpy(
            np.ascontiguousarray(arrays[i], np.float32))).numpy()
    return [np.ascontiguousarray(a, np.float32) for a in arrays]


def _torch(arrays, low, dtype):
    """The arrays at indices ``low`` in ``dtype``, the rest f32 (f64 for
    f64)."""
    rest = torch.float64 if dtype == torch.float64 else torch.float32
    return [torch.from_numpy(a).to(dtype if i in low else rest)
            for i, a in enumerate(arrays)]


def _excess(got, ref, tol):
    """max(|got - ref| - tol·|ref|): within atol = rtol = tol iff <= tol."""
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() - tol * ref.abs()).max())


def _normwise(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


SSD_LOW, WKV_LOW = (0, 3, 4, 6), (0, 1, 2, 3, 6)
# zamba2's widths (T = 512, chunk 64), a ragged T (chunk 50), G = 2 at N !=
# P; all at a small B·H
SSD_SHAPES = [(1, 512, 2, 64, 1, 64), (2, 100, 2, 64, 1, 64),
              (2, 128, 4, 32, 2, 16)]
# rwkv6-3b's widths, plain and at the clamps; a ragged T at N = 16
WKV_CASES = [((1, 512, 2, 64), False), ((2, 128, 2, 64), True),
             ((2, 100, 3, 16), False)]


@pytest.mark.parametrize("shape", [(1, 128, 2, 16, 1, 8),
                                   (2, 100, 4, 16, 2, 8)])
def test_ssd_chunk_parallel_form_is_the_plain_backward_in_f64(shape):
    """Without rounding the chunk-parallel form (increments, state passing,
    chunk gradients) is the plain backward, with and without dstate_T."""
    *ins, dy, dsT = _torch(_ssd_arrays(*shape, seed=1), SSD_LOW,
                           torch.float64)
    for ds in (dsT, None):
        got = ssd_bwd_rounded(*ins, dy, ds, mode="exact")
        want = mamba2_ssd_bwd_plain(*ins, dy, ds)
        for name, a, b in zip(SSD_NAMES, got, want):
            if b.abs().max() > 0:
                assert _normwise(a, b) <= NORMWISE, name


@pytest.mark.parametrize("shape,clamped", [((1, 128, 2, 16), True),
                                           ((2, 100, 3, 8), False)])
def test_wkv_chunk_parallel_form_is_the_plain_backward_in_f64(shape,
                                                              clamped):
    *ins, dout, dsT = _torch(_wkv_arrays(*shape, seed=1, clamped=clamped),
                             WKV_LOW, torch.float64)
    for ds in (dsT, None):
        got = wkv_bwd_rounded(*ins, dout, ds, mode="exact")
        want = rwkv6_wkv_bwd_plain(*ins, dout, ds)
        for name, a, b in zip(WKV_NAMES, got, want):
            if b.abs().max() > 0:
                assert _normwise(a, b) <= NORMWISE, name


@pytest.mark.parametrize("with_ds", [True, False])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_bwd_split_operands_within_gate_of_plain(shape, with_ds):
    """The route's operands keep every gradient, dA included, within the
    card's 1e-2 of the plain version, with and without a final-state
    gradient (the train step passes none)."""
    *ins, dy, dsT = _torch(_ssd_arrays(*shape, seed=2), SSD_LOW,
                           torch.bfloat16)
    ds = dsT if with_ds else None
    got = ssd_bwd_rounded(*ins, dy, ds)
    want = mamba2_ssd_bwd_plain(*ins, dy, ds)
    for name, a, b in zip(SSD_NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _excess(a, b, GATE) <= GATE, (name, _excess(a, b, GATE))


def test_ssd_bwd_single_rounding_misses_the_gate():
    """Why the route splits its operands: one bf16 rounding of each, as
    the SSD forward does, takes dx, dB and dC past 1e-2 + 1e-2·|ref| of the
    plain version at zamba2's widths."""
    *ins, dy, dsT = _torch(_ssd_arrays(*SSD_SHAPES[0], seed=2), SSD_LOW,
                           torch.bfloat16)
    got = ssd_bwd_rounded(*ins, dy, dsT, mode="round")
    want = mamba2_ssd_bwd_plain(*ins, dy, dsT)
    for name in ("dx", "dBm", "dCm"):
        i = SSD_NAMES.index(name)
        assert _excess(got[i], want[i], GATE) > GATE, name


@functools.lru_cache(maxsize=None)
def _ssd_jax_grads(shape, seed):
    arrays = _ssd_arrays(*shape, seed=seed)
    x, dt, A, Bm, Cm, s0 = (jnp.asarray(a, jnp.bfloat16 if i in (0, 3, 4)
                                        else jnp.float32)
                            for i, a in enumerate(arrays[:6]))
    dy, dsT = jnp.asarray(arrays[6]), jnp.asarray(arrays[7])

    def loss(*args):
        y, s = jmamba.ssd_chunked(*args, chunk=64)
        return (y.astype(jnp.float32) * dy).sum() + (s * dsT).sum()

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        x, dt, A, Bm, Cm, s0)
    return [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("shape", SSD_SHAPES[:2])
def test_ssd_bwd_split_operands_within_jax_grad_tolerance(shape):
    """Against ``jax.grad`` of the JAX chunked scan on the same bf16 x, B,
    C: within the SSD bf16 tolerance 6e-2, dA included."""
    want = _ssd_jax_grads(shape, 3)
    *ins, dy, dsT = _torch(_ssd_arrays(*shape, seed=3), SSD_LOW,
                           torch.bfloat16)
    got = ssd_bwd_rounded(*ins, dy, dsT)
    for name, a, b in zip(SSD_NAMES, got, want):
        np.testing.assert_allclose(a.float().numpy(), b, atol=SSD_JAX_TOL,
                                   rtol=SSD_JAX_TOL, err_msg=name)


@pytest.mark.parametrize("with_ds", [True, False])
@pytest.mark.parametrize("shape,clamped", WKV_CASES)
def test_wkv_bwd_split_operands_within_gate_of_plain(shape, clamped,
                                                     with_ds):
    """The split operands keep every gradient within the card's 1e-2 of the
    plain version, also where the cumsum passes -30 and w = 1e-9 (whose dw
    stays exactly 0)."""
    *ins, dout, dsT = _torch(_wkv_arrays(*shape, seed=4, clamped=clamped),
                             WKV_LOW, torch.bfloat16)
    ds = dsT if with_ds else None
    got = wkv_bwd_rounded(*ins, dout, ds)
    want = rwkv6_wkv_bwd_plain(*ins, dout, ds)
    for name, a, b in zip(WKV_NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _excess(a, b, GATE) <= GATE, (name, _excess(a, b, GATE))
    if clamped:
        c = pick_chunk(shape[1])
        assert torch.equal(got[3][:, 9::c, :, shape[3] // 2],
                           torch.zeros_like(got[3][:, 9::c, :,
                                                   shape[3] // 2]))


def test_wkv_bwd_single_rounding_misses_the_gate():
    """Why the route splits its operands (C4): one bf16 rounding of each
    takes dr, dk, dv and dw far past the card's gate at rwkv6-3b's
    widths."""
    *ins, dout, dsT = _torch(_wkv_arrays(*WKV_CASES[0][0], seed=4),
                             WKV_LOW, torch.bfloat16)
    got = wkv_bwd_rounded(*ins, dout, dsT, mode="round")
    want = rwkv6_wkv_bwd_plain(*ins, dout, dsT)
    for name in ("dr", "dk", "dv", "dw"):
        i = WKV_NAMES.index(name)
        assert _excess(got[i], want[i], GATE) > GATE, name


@functools.lru_cache(maxsize=None)
def _wkv_jax_grads(shape, seed, clamped):
    arrays = _wkv_arrays(*shape, seed=seed, clamped=clamped)
    r, k, v, w, u, s0 = (jnp.asarray(a, jnp.bfloat16 if i < 4
                                      else jnp.float32)
                         for i, a in enumerate(arrays[:6]))
    dout, dsT = jnp.asarray(arrays[6]), jnp.asarray(arrays[7])

    def loss(*args):
        out, s = jrwkv.wkv_chunked(*args, chunk=64)
        return (out.astype(jnp.float32) * dout).sum() + (s * dsT).sum()

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        r, k, v, w, u, s0)
    return [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("shape,clamped", WKV_CASES)
def test_wkv_bwd_split_operands_within_jax_grad_tolerance(shape, clamped):
    """Against ``jax.grad`` of the JAX chunked recurrence on the same bf16
    r, k, v, w: within the WKV bf16 tolerance 5e-2."""
    want = _wkv_jax_grads(shape, 5, clamped)
    *ins, dout, dsT = _torch(_wkv_arrays(*shape, seed=5, clamped=clamped),
                             WKV_LOW, torch.bfloat16)
    got = wkv_bwd_rounded(*ins, dout, dsT)
    for name, a, b in zip(WKV_NAMES, got, want):
        np.testing.assert_allclose(a.float().numpy(), b, atol=WKV_JAX_TOL,
                                   rtol=WKV_JAX_TOL, err_msg=name)
