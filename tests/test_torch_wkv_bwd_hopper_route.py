"""The WKV backward's Hopper route, emulated on the CPU in its own arithmetic.

``csrc/rwkv6_wkv_bwd.cu`` runs the bf16 backward at N = chunk = 64 on its
wgmma route (``rwkv6_wkv.bwd_route``; rwkv6-3b's train path): one block a
(batch, head) walks the chunks forwards, writing each chunk's start state
S_j as bf16 hi + lo tiles, then backwards with the gradient dS' of the
chunk's end state in f32. Its arithmetic is not ``wkv_bwd_rounded``'s
(``tests/test_torch_scan_bwd_rounding.py``):

- the decay is carried as running products, as in the forward's route:
  warp q of the pass (rows 4 q..4 q + 3) takes the running product of
  max(w, 1e-8) down its rows, the earlier warps' column products before
  it, e = max(that product, e^-30); r_dec = r (e (1 / w)), k_over = k (1 /
  e), exp(cum_L) = max(the column's product, e^-30), and a step passes
  dcum where the product is at or above e^-30;
- S_{j+1} = exp(cum_L) (S_j + k_overᵀ·v), S_j kept as hi + lo;
- dS' enters as D' = exp(cum_L) dS' (split): dk_scaled exp(cum_L) and
  k_scaled·dS' become v·D'ᵀ and k_over·D', so dk_over and dk_scaled share
  one sum, dk_tot = dscoresᵀ·r_dec + v·D'ᵀ, with dk = dk_tot / e + the
  bonus and dcum's terms -dk_tot k_over;
- the L-step term of dcum is Σ_m S_end ∘ dS' (S_end the next chunk's
  start state as hi + lo, or S_T in f32 for the last chunk), the same as Σ_s
  dk_scaled k_scaled + exp(cum_L) Σ_m S ∘ dS';
- dscores and its transpose come from dout·vᵀ and v·doutᵀ (exact), the
  scores' transpose from k_over·r_decᵀ with the bonus Σ_n r u k on its
  diagonal, each masked in f32 and split;
- every f32 operand is split into bf16 hi + lo and multiplied hi·hi +
  hi·lo + lo·hi (with an exact bf16 input hi·b + lo·b), but dscores·k_over
  (in dr_dec) and dscoresᵀ·r_dec (in dk_tot) take three parts of each
  operand and six part products (about 24 bits): at the -30 clamp dlogw
  is a small sum of large dcum terms, and with two parts dw misses the
  gate (a test below shows it at rwkv6-3b's full train shape).

This file writes that arithmetic in PyTorch (the emulation lives here, not
in the port) and holds it: without rounding, in f64, to the port's plain
backward within 1e-10; with the route's rounding, to the plain version and
to ``jax.grad`` of the JAX package's ``models/rwkv6.py::wkv_chunked``
within the card's bf16 gate (1e-2, ``chip_smoke.BWD_TOLERANCE``), at
rwkv6-3b's widths (T = 512, N = 64, chunk 64) for the draws of w that
``test_torch_scan_bwd_rounding.py`` uses (the -30 clamp and w < 1e-8
included), with and without a nonzero dstate_T. It shows that each lo
part is needed and that one rounding of every operand misses the gate.
Last, the route by dtype, N, chunk, T and alignment, in pure Python.
Inputs come from numpy with a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jrwkv
from repro_torch.kernels import rwkv6_wkv
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_bwd_plain

GATE = 1e-2             # chip_smoke.BWD_TOLERANCE["bfloat16"]
NORMWISE = 1e-10        # f64, no rounding
CLAMP = float(np.exp(-30.0))
ROWS = 4                # a pass warp's rows of a chunk
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")
# the operands the route splits into hi + lo
LO_PARTS = ("r_dec", "k_over", "state", "dstate", "dscores", "scores")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _parts(x, split, n=2):
    """x as the kernel feeds it to the tensor cores: with ``split`` its n
    bf16 parts (hi, lo = bf16(x - hi), with n = 3 also lo2 = bf16(x - hi
    - lo)), without [bf16(x)]; None: unrounded."""
    if split is None:
        return [x]
    parts = [_bf16(x)]
    while split and len(parts) < n:
        parts.append(_bf16(x - sum(parts)))
    return parts


def _product(eq, a, b):
    """The sum of the part products the kernel takes: those of order below
    the longer operand's parts (two parts each: all but lo·lo; three: the
    six of order at most two)."""
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(a)
               for j, y in enumerate(b) if i + j < max(len(a), len(b)))


def _decay(wt, wt_):
    """(e, the live mask, exp(cum_L), max(w, 1e-8)) of a chunk (B, 64, H,
    N) by the pass's running products."""
    B, c, H, N = wt.shape
    warps = c // ROWS
    wc = torch.clamp(wt, min=1e-8).reshape(B, warps, ROWS, H, N)
    inc = torch.empty_like(wc)
    run = torch.ones(B, warps, H, N, dtype=wt_)
    for i in range(ROWS):                    # down a warp's rows
        run = run * wc[:, :, i]
        inc[:, :, i] = run
    pre = torch.empty_like(run)
    acc = torch.ones(B, H, N, dtype=wt_)
    for q in range(warps):                   # the earlier warps' columns
        pre[:, q] = acc
        acc = acc * run[:, q]
    raw = (pre[:, :, None] * inc).reshape(B, c, H, N)
    return (torch.clamp(raw, min=CLAMP), raw >= CLAMP,
            torch.clamp(acc, min=CLAMP), wc.reshape(B, c, H, N))


def wkv_bwd_wgmma_route(r, k, v, w, u, state0, dout, dstate_T=None,
                        lo=LO_PARTS, rounded=True, parts=3):
    """``rwkv6_wkv_bwd_plain`` in the wgmma route's arithmetic at chunk
    64. ``lo``: the operands split (the others rounded once to bf16);
    ``rounded=False``: no rounding at all (f64 stays f64); ``parts``: the
    parts of dscores, k_over and r_dec in dscores·k_over and
    dscoresᵀ·r_dec (the route's 3, or 2 as in its other products)."""
    B, T, H, N = r.shape
    c, K = 64, T // 64
    wt_ = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, wf, dof = (a.to(wt_) for a in (r, k, v, w, dout))
    uf = u.to(wt_)

    def split(name):
        return (name in lo) if rounded else None

    def chunk(a, j):
        return a[:, 64 * j:64 * j + 64]

    # phase 1: the chunk-start states, kept as the route's operands
    S = state0.to(wt_)
    states = []
    for j in range(K):
        states.append(_parts(S, split("state")))
        e, _, p, _ = _decay(chunk(wf, j), wt_)
        k_over = _parts(chunk(kf, j) * (1.0 / e), split("k_over"))
        S = (S + _product("bshn,bshm->bhnm", k_over, [chunk(vf, j)])) \
            * p[..., None]
    # phase 2
    lower = torch.ones(c, c, dtype=torch.bool).tril(-1)   # [t, s], s < t
    upper = lower.T                                         # [s, t], t > s
    eye = torch.eye(c, dtype=torch.bool)
    dS = (torch.zeros_like(S) if dstate_T is None else dstate_T.to(wt_))
    s_end = [S]                       # the last chunk's end state, f32
    grads = [torch.empty_like(rf) for _ in range(4)]
    du = torch.zeros_like(uf)
    for j in reversed(range(K)):
        rt, kt, vt, wt, dot = (chunk(a, j) for a in (rf, kf, vf, wf, dof))
        e, live, p, wc = _decay(wt, wt_)
        iw = 1.0 / wc
        r_dec_f = rt * (e * iw)
        k_over_f = kt * (1.0 / e)
        r_dec = _parts(r_dec_f, split("r_dec"))
        k_over = _parts(k_over_f, split("k_over"))
        r_dec3 = _parts(r_dec_f, split("r_dec"), parts)
        k_over3 = _parts(k_over_f, split("k_over"), parts)
        bonus = torch.einsum("bthn,bthn->bht", rt * uf, kt)
        ddiag = torch.einsum("bthm,bthm->bht", dot, vt)
        # the L-step term: Σ_m S_end ∘ dS'
        tail = (sum(s_end) * dS).sum(-1)                    # (B, H, N)
        dsc = torch.einsum("bthm,bshm->bhts", dot, vt)
        dsc = _parts(torch.where(lower, dsc, torch.zeros_like(dsc)),
                     split("dscores"), parts)
        dr_dec = (_product("bthm,bhnm->bthn", [dot], states[j])
                  + _product("bhts,bshn->bthn", dsc, k_over3))
        d_prime = dS * p[..., None]
        dp = _parts(d_prime, split("dstate"))
        dS = d_prime + _product("bthn,bthm->bhnm", r_dec, [dot])
        s_end = states[j]
        dscT = torch.einsum("bshm,bthm->bhst", vt, dot)
        dscT = _parts(torch.where(upper, dscT, torch.zeros_like(dscT)),
                      split("dscores"), parts)
        dk_tot = (_product("bhst,bthn->bshn", dscT, r_dec3)
                  + _product("bshm,bhnm->bshn", [vt], dp))
        scT = _product("bshn,bthn->bhst", k_over, r_dec)
        scT = torch.where(upper, scT, torch.where(
            eye, bonus[..., None].expand_as(scT), torch.zeros_like(scT)))
        dv = (_product("bhst,bthm->bshm", _parts(scT, split("scores")),
                       [dot])
              + _product("bshn,bhnm->bshm", k_over, dp))
        # the pass's epilogue, in f32
        bon = ddiag.transpose(1, 2)[..., None] * uf         # (B, c, H, N)
        x = dr_dec * r_dec_f
        dr = dr_dec * (e * iw) + bon * kt
        dk = dk_tot * (1.0 / e) + bon * rt
        du = du + torch.einsum("bth,bthn->hn", ddiag.transpose(1, 2),
                               rt * kt)
        dcum = x - dk_tot * k_over_f
        dcum[:, -1] += tail
        dcum = torch.where(live, dcum, torch.zeros_like(dcum))
        dlogw = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1]) - x
        dw = torch.where(wt >= 1e-8, dlogw * iw, torch.zeros_like(dlogw))
        for grad, val in zip(grads, (dr, dk, dv, dw)):
            grad[:, 64 * j:64 * j + 64] = val
    return (*(g.to(r.dtype) for g in grads), du, dS)


def _arrays(B, T, H, N, seed, clamped=False):
    """r, k, v ~ N/2, w = exp(-exp(N/2 - 2)), u ~ 0.3 N, state0 ~ N/10,
    dout ~ N, dstate_T ~ N as f32 numpy, the bf16 inputs rounded; as
    ``test_torch_scan_bwd_rounding._wkv_arrays`` draws them. ``clamped``: a
    quarter of the channels decay by e^-0.5..e^-3 a step (the cumsum
    passes -30 inside a chunk) and channel N/2 has w = 1e-9 at the 10th
    step of each chunk."""
    rng = np.random.default_rng(seed)

    def draw(*s):
        return rng.standard_normal(s).astype(np.float32)

    r, k, v = (draw(B, T, H, N) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(draw(B, T, H, N) * 0.5 - 2.0))
    if clamped:
        q = max(1, N // 4)
        w[..., :q] = np.exp(-rng.uniform(0.5, 3.0, (B, T, H, q)))
        w[:, 9::64, :, N // 2] = 1e-9
    arrays = [r, k, v, w, draw(H, N) * 0.3, draw(B, H, N, N) * 0.1,
              draw(B, T, H, N), draw(B, H, N, N)]
    for i in (0, 1, 2, 3, 6):
        arrays[i] = _bf16(torch.from_numpy(
            np.ascontiguousarray(arrays[i], np.float32))).numpy()
    return [np.ascontiguousarray(a, np.float32) for a in arrays]


LOW = (0, 1, 2, 3, 6)


def _torch(arrays, dtype):
    rest = torch.float64 if dtype == torch.float64 else torch.float32
    return [torch.from_numpy(a).to(dtype if i in LOW else rest)
            for i, a in enumerate(arrays)]


def _excess(got, ref, tol):
    """max(|got - ref| - tol·|ref|): within atol = rtol = tol iff <= tol."""
    got = torch.as_tensor(got).double()
    ref = torch.as_tensor(ref).double()
    return float(((got - ref).abs() - tol * ref.abs()).max())


def _normwise(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


MAIN = (1, 512, 2, 64)        # rwkv6-3b's widths at a small B·H
CASES = [(MAIN, False), (MAIN, True)]


@pytest.mark.parametrize("clamped", [False, True])
@pytest.mark.parametrize("shape", [(1, 64, 2, 64), (2, 192, 1, 64)])
def test_route_arithmetic_is_the_plain_backward_in_f64(shape, clamped):
    """Without rounding the running products, D', the shared dk_tot, the
    L-step term from the end state and the transposed scores are the plain
    backward, with and without dstate_T."""
    *ins, dout, dsT = _torch(_arrays(*shape, seed=1, clamped=clamped),
                             torch.float64)
    for ds in (dsT, None):
        got = wkv_bwd_wgmma_route(*ins, dout, ds, rounded=False)
        want = rwkv6_wkv_bwd_plain(*ins, dout, ds)
        for name, a, b in zip(NAMES, got, want):
            assert a.shape == b.shape, name
            assert _normwise(a, b) <= NORMWISE, name


@functools.lru_cache(maxsize=None)
def _plain(clamped, with_ds, seed):
    *ins, dout, dsT = _torch(_arrays(*MAIN, seed=seed, clamped=clamped),
                             torch.bfloat16)
    return rwkv6_wkv_bwd_plain(*ins, dout, dsT if with_ds else None)


@functools.lru_cache(maxsize=None)
def _route(clamped, with_ds, seed, lo=LO_PARTS):
    *ins, dout, dsT = _torch(_arrays(*MAIN, seed=seed, clamped=clamped),
                             torch.bfloat16)
    return wkv_bwd_wgmma_route(*ins, dout, dsT if with_ds else None, lo=lo)


@pytest.mark.parametrize("with_ds", [True, False])
@pytest.mark.parametrize("clamped", [False, True])
def test_route_rounding_within_gate_of_plain(clamped, with_ds):
    """The route's rounding keeps every gradient within the card's 1e-2 of
    the plain version, also where the decay reaches e^-30 and w = 1e-9
    (whose dw stays exactly 0), with and without a final-state gradient
    (the train step passes none)."""
    got, want = _route(clamped, with_ds, 4), _plain(clamped, with_ds, 4)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _excess(a, b, GATE) <= GATE, (name, _excess(a, b, GATE))
    if clamped:
        assert torch.equal(got[3][:, 9::64, :, 32],
                           torch.zeros_like(got[3][:, 9::64, :, 32]))


@functools.lru_cache(maxsize=None)
def _jax_grads(clamped, with_ds, seed):
    arrays = _arrays(*MAIN, seed=seed, clamped=clamped)
    r, k, v, w, u, s0 = (jnp.asarray(a, jnp.bfloat16 if i < 4
                                      else jnp.float32)
                         for i, a in enumerate(arrays[:6]))
    dout = jnp.asarray(arrays[6])
    dsT = jnp.asarray(arrays[7]) if with_ds else jnp.zeros_like(s0)

    def loss(*args):
        out, s = jrwkv.wkv_chunked(*args, chunk=64)
        return (out.astype(jnp.float32) * dout).sum() + (s * dsT).sum()

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        r, k, v, w, u, s0)
    return [np.array(g, np.float32) for g in grads]


@pytest.mark.parametrize("with_ds", [True, False])
@pytest.mark.parametrize("clamped", [False, True])
def test_route_rounding_within_gate_of_jax_grad(clamped, with_ds):
    """Against ``jax.grad`` of the JAX chunked recurrence on the same bf16
    r, k, v, w: every gradient within the card's 1e-2."""
    got = _route(clamped, with_ds, 5)
    for name, a, b in zip(NAMES, got, _jax_grads(clamped, with_ds, 5)):
        assert _excess(a.float(), torch.from_numpy(b), GATE) <= GATE, (
            name, _excess(a.float(), torch.from_numpy(b), GATE))


@pytest.mark.parametrize("part", LO_PARTS)
def test_each_lo_part_is_needed(part):
    """Dropping the lo part of any one operand (that operand rounded once
    to bf16) takes some gradient past 1e-2 + 1e-2·|ref| of the plain
    version in at least one of the draws, while the full split stays
    inside."""
    worst = 0.0
    for clamped in (False, True):
        got = _route(clamped, True, 4,
                     tuple(x for x in LO_PARTS if x != part))
        want = _plain(clamped, True, 4)
        worst = max(worst, max(_excess(a, b, GATE)
                               for a, b in zip(got, want)))
    assert worst > GATE


def _card_clamped_inputs(shape):
    """The inputs of ``test_torch_gpu``'s card check of the route with w at
    both clamps (``_scan_inputs(..., seed=3)`` then ``_wkv_clamped``), as
    bf16 and f32 CPU tensors: r, k, v ~ N/2, w = exp(-exp(N/2 - 2)) with a
    quarter of the channels decaying by e^-0.5..e^-3 a step and w = 1e-9 at
    the 10th step of each chunk in channel N/2, u, state0, dout."""
    B, T, H, N = shape
    rng = np.random.default_rng(3)

    def draw(*s):
        return rng.standard_normal(s).astype(np.float32)

    r, k, v = (draw(B, T, H, N) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(draw(B, T, H, N) * 0.5 - 2.0))
    u, s0 = draw(H, N) * 0.3, draw(B, H, N, N) * 0.1
    dout = np.random.default_rng(103).standard_normal(
        (B, T, H, N)).astype(np.float32)
    low = [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
           for a in (r, k, v, w)]
    q = N // 4
    decay = np.random.default_rng(19).uniform(0.5, 3.0, (B, T, H, q))
    low[3][..., :q] = torch.from_numpy(
        np.exp(-decay.astype(np.float32))).to(torch.bfloat16)
    low[3][:, 9::64, :, N // 2] = 1e-9
    return (*low, torch.from_numpy(u), torch.from_numpy(s0),
            torch.from_numpy(dout).to(torch.bfloat16))


def test_three_parts_needed_at_the_clamp_at_full_size():
    """At rwkv6-3b's train shape with w at both clamps, two parts of
    dscores, k_over and r_dec in dscores·k_over and dscoresᵀ·r_dec take dw
    past the gate at a few elements (there dlogw is a small sum of large
    dcum terms, divided by w near 0.05); the route's three parts keep every
    gradient inside, with room."""
    ins = _card_clamped_inputs((4, 512, 40, 64))
    want = rwkv6_wkv_bwd_plain(*ins)
    two = wkv_bwd_wgmma_route(*ins, parts=2)
    assert _excess(two[3], want[3], GATE) > GATE
    three = wkv_bwd_wgmma_route(*ins)
    for name, a, b in zip(NAMES, three, want):
        assert _excess(a, b, GATE) <= GATE / 2, (name, _excess(a, b, GATE))


def test_single_rounding_misses_the_gate():
    """One bf16 rounding of every operand misses the gate by far (C4)."""
    got = _route(False, True, 4, ())
    want = _plain(False, True, 4)
    for name in ("dr", "dk", "dv", "dw"):
        i = NAMES.index(name)
        assert _excess(got[i], want[i], GATE) > GATE, name


# chip_smoke's WKV backward shapes and the card tests', with the route each
# takes in bf16 on aligned tensors
ROUTES = [((4, 512, 40, 64), "wgmma"),    # rwkv6-3b's train shape
          ((1, 512, 40, 64), "wgmma"),    # one batch row of its heads
          ((2, 128, 3, 64), "wgmma"),     # two chunks (the clamped draw)
          ((1, 64, 1, 64), "wgmma"),      # one chunk, one head
          ((4, 100, 40, 64), "mma"),      # chunk 50
          ((1, 97, 2, 64), "mma"),        # chunk 1 (T prime)
          ((2, 100, 3, 16), "mma"),       # N = 16
          ((1, 100, 2, 5), "mma"),        # N = 5
          ((2, 100, 4, 32), "mma"),       # N = 32
          ((2, 128, 4, 32), "mma")]       # N = 32 at chunk 64


@pytest.mark.parametrize("shape,route", ROUTES)
def test_bwd_route_by_shape(shape, route):
    """The route by dtype and shape alone: bf16 at N = 64 with the chunk
    64 takes the wgmma kernel, whatever B, H and the number of chunks;
    other bf16 shapes mma.sync; f32 the CUDA cores."""
    x = torch.zeros(shape, dtype=torch.bfloat16)
    assert rwkv6_wkv.bwd_route(x, x, x, x, x) == route
    xf = x.float()
    assert rwkv6_wkv.bwd_route(xf, xf, xf, xf, xf) == "f32"


def test_bwd_route_follows_the_chunk_argument():
    """A chunk argument below 64 gives chunk 32 at T = 512: mma.sync."""
    x = torch.zeros(1, 512, 2, 64, dtype=torch.bfloat16)
    assert rwkv6_wkv.bwd_route(x, x, x, x, x, chunk=64) == "wgmma"
    assert rwkv6_wkv.bwd_route(x, x, x, x, x, chunk=32) == "mma"


@pytest.mark.parametrize("which", range(5))
def test_bwd_route_of_an_unaligned_view_is_mma(which):
    """Any of r, k, v, w, dout whose data is not 16-byte aligned cannot be
    a TMA map's: the call keeps mma.sync; a contiguous copy takes wgmma."""
    shape = (1, 128, 2, 64)
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16)
    view = flat[1:].view(shape)
    assert view.data_ptr() % 16 != 0
    args = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(5)]
    args[which] = view
    assert rwkv6_wkv.bwd_route(*args) == "mma"
    args[which] = view.clone()
    assert rwkv6_wkv.bwd_route(*args) == "wgmma"


def test_bwd_routes_counter_is_a_counter_by_route_name():
    """``rwkv6_wkv_bwd.routes`` counts calls by ``bwd_route``'s names; the
    route names are the launcher's dtype codes 0, 1, 2."""
    assert rwkv6_wkv.BWD_ROUTES == ("f32", "mma", "wgmma")
    routes = rwkv6_wkv.rwkv6_wkv_bwd.routes
    assert hasattr(routes, "most_common") and hasattr(routes, "update")
