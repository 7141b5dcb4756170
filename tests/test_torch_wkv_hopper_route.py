"""The WKV forward's Hopper route, emulated on the CPU in its own arithmetic.

``csrc/rwkv6_wkv.cu`` runs the bf16 forward at N = chunk = 64 on its wgmma
route (``rwkv6_wkv.fwd_route``; rwkv6-3b's serve and train paths). Its
arithmetic is not ``wkv_rounded``'s (``tests/test_torch_tensor_core_rounding
.py``) in two ways. The decay is carried as a product and not as a sum of
logs: per chunk, warp q of the pass (rows 8 q..8 q + 7) takes the running
product of max(w, 1e-8) down its rows, the products of the earlier warps'
columns before it, e = max(that product, e^-30) (the same clamps as the
Pallas body's max(cumsum(log w), -30)), r_dec = r (e / w), k_over = k / e
and exp(cum[c-1]) = max(the whole column's product, e^-30). And the
diagonal bonus sum_n r u k sits on the diagonal of the scores, so it is
split into bf16 hi + lo with them and reaches out through scores . v.
Every f32 operand of a product is split into bf16 hi + lo and multiplied
hi.hi + hi.lo + lo.hi (one product of each part with the exact bf16 v):
r_dec, k_over, the masked scores and the carried state; the state's update
is exp(cum[c-1]) (S + k_overᵀ·v).

This file writes that arithmetic in PyTorch (the emulation lives here, not
in the port) and holds it: without rounding, in f64, to the port's plain
version within 1e-10; with the route's rounding, to the JAX package's
Pallas ``wkv`` in interpret mode and its ``wkv_ref`` within the JAX bf16
tolerance (out 5e-2, the final state 10x that, as ``chip_smoke.py``), at
rwkv6-3b's widths (T = 512, N = 64, chunk 64) for the three draws of w
that ``test_torch_tensor_core_rounding.py`` uses (the clamp included), and
to the plain version within the card's gate. It shows that each lo part is
needed: dropping one takes out past the tolerance in at least one draw. A
sequence cut at a chunk boundary and carried by its state gives the same
bits. Last, the route by dtype, N, chunk, T and alignment, in pure Python.
Inputs come from numpy with a seed.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import rwkv6_wkv
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_plain

TOL = 5e-2              # tests/test_kernels.py's WKV bf16 tolerance (out)
STATE_TOL = 10 * TOL    # chip_smoke.py's WKV state tolerance
NORMWISE = 1e-10        # f64, no rounding
CLAMP = float(np.exp(-30.0))
LO_PARTS = ("r_dec", "k_over", "scores", "state")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _parts(x, split):
    """x as the kernel feeds it to the tensor cores: [bf16(x)], or with
    ``split`` [hi, lo] with lo = bf16(x - hi); unrounded without ``lo``
    (None: f64 runs)."""
    if split is None:
        return [x]
    hi = _bf16(x)
    return [hi, _bf16(x - hi)] if split else [hi]


def _product(eq, a, b):
    """The sum of the part products the kernel takes: all but lo.lo."""
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(a)
               for j, y in enumerate(b) if i + j < 2)


def wkv_wgmma_route(r, k, v, w, u, state0, lo=LO_PARTS, rounded=True):
    """``rwkv6_wkv_plain`` in the wgmma route's arithmetic at chunk 64.
    ``lo``: the operands split into hi + lo (the others rounded once to
    bf16); ``rounded=False``: no rounding at all (f64 inputs stay f64)."""
    B, T, H, N = r.shape
    c = 64
    wt_ = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, wf = (a.to(wt_) for a in (r, k, v, w))
    uf = u.to(wt_)
    S = state0.to(wt_)
    strict = torch.ones(c, c, dtype=torch.bool).tril(-1)
    eye = torch.eye(c, dtype=torch.bool)

    def split(name):
        return (name in lo) if rounded else None

    outs = []
    for t0 in range(0, T, c):
        rt, kt, vt, wt = (a[:, t0:t0 + c] for a in (rf, kf, vf, wf))
        wc = torch.clamp(wt, min=1e-8).reshape(B, 8, 8, H, N)
        inc = torch.empty_like(wc)
        run = torch.ones(B, 8, H, N, dtype=wt_)
        for i in range(8):                       # down a warp's rows
            run = run * wc[:, :, i]
            inc[:, :, i] = run
        pre = torch.empty_like(run)
        acc = torch.ones(B, H, N, dtype=wt_)
        for q in range(8):                       # the earlier warps' columns
            pre[:, q] = acc
            acc = acc * run[:, q]
        e = torch.clamp(pre[:, :, None] * inc, min=CLAMP).reshape(B, c, H, N)
        p = torch.clamp(acc, min=CLAMP)          # exp(cum[c-1])
        wcf = wc.reshape(B, c, H, N)
        r_dec = _parts(rt * (e * (1.0 / wcf)), split("r_dec"))
        k_over = _parts(kt * (1.0 / e), split("k_over"))
        y = _product("bthn,bhnm->bthm", r_dec, _parts(S, split("state")))
        sc = _product("bthn,bshn->bhts", r_dec, k_over)
        bonus = torch.einsum("bthn,bthn->bht", rt * uf, kt)
        sc = torch.where(strict, sc, torch.where(
            eye, bonus[..., None].expand_as(sc), torch.zeros_like(sc)))
        outs.append(y + _product("bhts,bshm->bthm",
                                 _parts(sc, split("scores")), [vt]))
        S = (S + _product("bshn,bshm->bhnm", k_over, [vt])) * p[..., None]
    return torch.cat(outs, 1).to(r.dtype), S


def _inputs(B, T, H, N, draw, seed):
    """r, k, v ~ N/2, u ~ 0.3 N, state0 ~ N/10 as f32 numpy, and w drawn
    three ways as ``test_torch_tensor_core_rounding._wkv_inputs`` draws
    it: as the JAX kernel test does (about 0.87), near 1 (0.99 to 0.999,
    the served model's decays) and small (about 0.37: the cumulative decay
    reaches the e^-30 clamp inside a chunk)."""
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
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def _torch(arrays, low=torch.bfloat16):
    return [torch.from_numpy(a).to(low if i < 4 else torch.float32)
            for i, a in enumerate(arrays)]


def _jax(arrays):
    return [jnp.asarray(a, jnp.bfloat16 if i < 4 else jnp.float32)
            for i, a in enumerate(arrays)]


def _excess(got, ref, tol):
    """max(|got - ref| - tol·|ref|): within atol = rtol = tol iff <= tol."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float((np.abs(got - ref) - tol * np.abs(ref)).max())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


DRAWS = ["jax", "near_one", "clamp"]


@pytest.mark.parametrize("draw", DRAWS)
@pytest.mark.parametrize("shape", [(1, 64, 2, 64), (2, 192, 2, 64),
                                   (1, 320, 2, 64)])
def test_route_arithmetic_is_the_plain_forward_in_f64(shape, draw):
    """Without rounding, the running products, the clamps and the bonus on
    the scores' diagonal are the plain chunked scan."""
    ins = [torch.from_numpy(a).double()
           for a in _inputs(*shape, draw, seed=1)]
    out, state = wkv_wgmma_route(*ins, rounded=False)
    want_out, want_state = rwkv6_wkv_plain(*ins)
    for got, want in ((out, want_out), (state, want_state)):
        assert got.shape == want.shape
        assert float((got - want).norm() / want.norm()) <= NORMWISE


@functools.lru_cache(maxsize=None)
def _jax_results(draw, seed):
    """(out, state) as f32 numpy of the Pallas kernel in interpret mode
    and, where the decay stays above the clamp, of JAX's step-by-step
    reference, on the draw's bf16 inputs at rwkv6-3b's widths (computed
    once a draw)."""
    j = _jax(_inputs(1, 512, 2, 64, draw, seed))
    pallas = jops.rwkv6_wkv(*j, chunk=64, interpret=True)
    found = {"pallas": tuple(_f32(a) for a in pallas)}
    if draw != "clamp":
        found["ref"] = tuple(_f32(a) for a in jref.wkv_ref(*j))
    return found


def _oracle(draw, seed):
    """JAX's step-by-step reference; where the decay reaches the clamp, the
    Pallas kernel in interpret mode, since the clamped chunked form departs
    from the unclamped recurrence by design."""
    found = _jax_results(draw, seed)
    return found["ref"] if "ref" in found else found["pallas"]


@pytest.mark.parametrize("draw", DRAWS)
def test_route_rounding_within_jax_bf16_tolerance(draw):
    """At rwkv6-3b's widths with the route's rounding: out within 5e-2 and
    the final state within 5e-1 of the Pallas kernel in interpret mode and
    of JAX's reference (the Pallas kernel alone where the clamp is
    reached)."""
    out, state = wkv_wgmma_route(*_torch(_inputs(1, 512, 2, 64, draw, 25)))
    for jout, jstate in _jax_results(draw, 25).values():
        assert _excess(_f32(out), _f32(jout), TOL) <= TOL
        assert _excess(state.numpy(), _f32(jstate), STATE_TOL) <= STATE_TOL


@pytest.mark.parametrize("draw", DRAWS)
def test_route_rounding_close_to_plain(draw):
    """The split keeps about 16 bits of each operand: out within one bf16
    step of the plain version's on the same inputs (far inside the card's
    5e-2 gate), the final state within 1e-3."""
    t = _torch(_inputs(1, 512, 2, 64, draw, seed=27))
    out, state = wkv_wgmma_route(*t)
    pout, pstate = rwkv6_wkv_plain(*t)
    step = 2.0 ** -7 * np.maximum(np.abs(_f32(pout)), 1.0)
    assert (np.abs(_f32(out) - _f32(pout)) <= step).all()
    np.testing.assert_allclose(state.numpy(), pstate.numpy(), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("part", LO_PARTS)
def test_each_lo_part_is_needed(part):
    """Dropping the lo part of any one operand (that operand rounded once
    to bf16) takes out past 5e-2 + 5e-2·|ref| of JAX's oracle in at least
    one of the three draws, while the full split stays inside."""
    worst = 0.0
    for draw in DRAWS:
        jout, _ = _oracle(draw, 25)
        out, _ = wkv_wgmma_route(
            *_torch(_inputs(1, 512, 2, 64, draw, 25)),
            lo=tuple(x for x in LO_PARTS if x != part))
        worst = max(worst, _excess(_f32(out), _f32(jout), TOL))
    assert worst > TOL


@pytest.mark.parametrize("cut", [64, 128, 192])
def test_route_split_at_a_chunk_carries_the_state(cut):
    """The walk is the same whether a sequence comes in one call or in two
    cut at a chunk boundary, the second from the first's final state (as
    prefill hands its state on): equal bits at the route's rounding."""
    r, k, v, w, u, s0 = _torch(_inputs(1, 256, 2, 64, "jax", seed=4))
    out, state = wkv_wgmma_route(r, k, v, w, u, s0)
    o1, s1 = wkv_wgmma_route(r[:, :cut], k[:, :cut], v[:, :cut],
                             w[:, :cut], u, s0)
    o2, s2 = wkv_wgmma_route(r[:, cut:], k[:, cut:], v[:, cut:],
                             w[:, cut:], u, s1)
    assert torch.equal(torch.cat([o1, o2], 1), out)
    assert torch.equal(s2, state)


# chip_smoke.WKV_SHAPES and the card tests' shapes, with the route each
# takes in bf16 on aligned tensors
ROUTES = [((4, 512, 40, 64), "wgmma"),    # rwkv6-3b's serve and train shape
          ((1, 512, 40, 64), "wgmma"),    # one batch row of its heads
          ((2, 128, 3, 64), "wgmma"),     # two chunks
          ((1, 64, 1, 64), "wgmma"),      # one chunk, one head
          ((2, 1024, 4, 64), "wgmma"),    # 16 chunks
          ((4, 100, 40, 64), "mma"),      # chunk 50
          ((1, 97, 2, 64), "mma"),        # chunk 1 (T prime)
          ((1, 32, 2, 64), "mma"),        # T below a chunk of 64: chunk 32
          ((2, 96, 3, 64), "mma"),        # chunk 48
          ((2, 100, 3, 16), "mma"),       # N = 16
          ((1, 97, 2, 24), "mma"),        # N = 24
          ((2, 128, 4, 32), "mma"),       # N = 32 at chunk 64
          ((1, 100, 2, 5), "mma")]        # N = 5


@pytest.mark.parametrize("shape,route", ROUTES)
def test_fwd_route_by_shape(shape, route):
    """The route by dtype and shape alone: bf16 at N = 64 with the chunk
    64 takes the wgmma kernel, whatever B, H and the number of chunks;
    other bf16 shapes mma.sync; f32 the CUDA cores."""
    x = torch.zeros(shape, dtype=torch.bfloat16)
    assert rwkv6_wkv.fwd_route(x, x, x, x) == route
    xf = x.float()
    assert rwkv6_wkv.fwd_route(xf, xf, xf, xf) == "f32"


def test_fwd_route_follows_the_chunk_argument():
    """A chunk argument below 64 gives chunk 32 at T = 512: mma.sync."""
    x = torch.zeros(1, 512, 2, 64, dtype=torch.bfloat16)
    assert rwkv6_wkv.fwd_route(x, x, x, x, chunk=64) == "wgmma"
    assert rwkv6_wkv.fwd_route(x, x, x, x, chunk=32) == "mma"


@pytest.mark.parametrize("which", range(4))
def test_fwd_route_of_an_unaligned_view_is_mma(which):
    """Any of r, k, v, w whose data is not 16-byte aligned cannot be a TMA
    map's: the call keeps mma.sync; a contiguous copy takes wgmma."""
    shape = (1, 128, 2, 64)
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16)
    view = flat[1:].view(shape)
    assert view.data_ptr() % 16 != 0
    args = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(4)]
    args[which] = view
    assert rwkv6_wkv.fwd_route(*args) == "mma"
    args[which] = view.clone()
    assert rwkv6_wkv.fwd_route(*args) == "wgmma"


def test_routes_counter_is_a_counter_by_route_name():
    """``rwkv6_wkv.routes`` counts calls by ``fwd_route``'s names; the
    route names are the launcher's dtype codes 0, 1, 2."""
    assert rwkv6_wkv.FWD_ROUTES == ("f32", "mma", "wgmma")
    assert hasattr(rwkv6_wkv.rwkv6_wkv.routes, "most_common")
