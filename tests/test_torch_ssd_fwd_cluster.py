"""The SSD forward's Hopper route, emulated on the CPU in its own order of
sums and rounding points.

``csrc/mamba2_ssd.cu`` runs the bf16 forward at N = P = chunk = 64 on its
warpgroup route (``mamba2_ssd.fwd_route``; zamba2's serve and train
paths): one warpgroup per (batch, head) walks the chunks with S in f32.
Per chunk it forms the masked scores P = (C·Bᵀ) ∘ decay ∘ dt rounded to
bf16 and the increment L_c = (B ∘ w)ᵀ·x with B ∘ w rounded to bf16; S_{c+1}
= e^{cum_L,c} S_c, then L_c added onto it by the tensor cores; y = P·x + (C
∘ e^{cum})·S_c, with C ∘ e^{cum} and S_c rounded to bf16 as operands.

This file writes that schedule in PyTorch (the emulation lives here, not
in the port) and holds it to the port's plain version ``mamba2_ssd_plain``:
in f64 without rounding within 1e-10, and at bf16 with the route's
rounding within 6e-2, the gate ``chip_smoke.py`` holds the kernel to on
the card; and to the JAX package's Pallas ``ssd`` in interpret mode and its
``ssd_ref`` within the JAX bf16 tolerance 6e-2. It also checks that a
sequence split at a chunk boundary and carried by its state gives the
same bits, and the routes by shape. Widths are zamba2's (P = N = 64, chunk
64) at a few heads, with a nonzero state0; inputs come from numpy with a
seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mamba2_ssd
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_plain, pick_chunk

GATE = 6e-2            # chip_smoke.TOLERANCE["mamba2_ssd"]["bfloat16"]
JAX_TOL = 6e-2         # tests/test_kernels.py's SSD bf16 tolerance
NORMWISE = 1e-10       # f64, no rounding
# zamba2's widths at 1, 2, 3, 5, 8, 9 and 16 chunks, one and two B/C
# groups
ZAMBA = [(1, 64, 2, 64, 1, 64), (2, 128, 3, 64, 1, 64),
         (1, 192, 2, 64, 1, 64), (2, 320, 2, 64, 2, 64),
         (1, 512, 4, 64, 1, 64), (1, 512, 4, 64, 2, 64),
         (1, 576, 2, 64, 2, 64), (1, 1024, 2, 64, 1, 64)]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and back to its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def ssd_fwd_route(x, dt, A, Bm, Cm, state0, rounded=True, chunk=64):
    """``mamba2_ssd_plain`` in the warpgroup route's order: every chunk's L
    and P, the state's walk in chunk order, then each chunk's readout.
    ``rounded``: the route's bf16 operands (B ∘ w, P, S_c, C ∘ e^{cum});
    otherwise none (f64 inputs stay f64)."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    c = pick_chunk(T, chunk)
    K = T // c
    wt = torch.float64 if x.dtype == torch.float64 else torch.float32
    rnd = _bf16 if rounded else (lambda t: t)
    xk = x.to(wt).reshape(Bsz, K, c, H, P)
    dtk = dt.to(wt).reshape(Bsz, K, c, H)
    Bk, Ck = (a.to(wt).reshape(Bsz, K, c, G, N)
              .repeat_interleave(H // G, dim=3) for a in (Bm, Cm))
    cum = torch.cumsum(dtk * A.to(wt), dim=2)             # (B, K, c, H)
    ecum = torch.exp(cum)
    elast = ecum[:, :, -1]                                # (B, K, H)
    w = torch.exp(cum[:, :, -1:] - cum) * dtk
    L = torch.einsum("bkshn,bkshp->bkhnp", rnd(Bk * w[..., None]), xk)
    tri = torch.ones(c, c, dtype=torch.bool).tril()
    scores = torch.einsum("bkthn,bkshn->bkhts", Ck, Bk)
    diff = (cum[:, :, :, None] - cum[:, :, None, :]).permute(0, 1, 4, 2, 3)
    decay = torch.exp(torch.clamp(diff, max=0.0))
    Pm = torch.where(tri, scores * decay
                     * dtk.permute(0, 1, 3, 2)[:, :, :, None, :],
                     torch.zeros_like(scores))
    y = torch.einsum("bkhts,bkshp->bkthp", rnd(Pm), xk)
    S = [state0.to(wt)]
    for k in range(K):
        # S scaled in f32, then the increment summed onto it
        S.append((elast[:, k, :, None, None] * S[k]).to(wt) + L[:, k])
    Sc = rnd(torch.stack(S[:K], 1))                       # (B, K, H, N, P)
    y = y + torch.einsum("bkthn,bkhnp->bkthp", rnd(Ck * ecum[..., None]), Sc)
    return y.reshape(Bsz, T, H, P).to(x.dtype), S[K]


def _arrays(B, T, H, P, G, N, seed):
    """x, dt (softplus-ed), A (negative), Bm, Cm ~ N/2, state0 ~ N/10 as f32
    numpy, as the JAX kernel tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, T, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T, G, N)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, P)) * 0.1).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


LOW = (0, 3, 4)        # x, Bm and Cm take the working dtype


def _torch(arrays, low):
    return [torch.from_numpy(a).to(low if i in LOW else torch.float32)
            for i, a in enumerate(arrays)]


def _excess(got, ref, tol):
    """max(|got - ref| - tol·|ref|): within atol = rtol = tol iff <= tol."""
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() - tol * ref.abs()).max())


def _normwise(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


@pytest.mark.parametrize("shape", ZAMBA)
def test_route_order_is_the_plain_forward_in_f64(shape):
    """Without rounding, the route's order (the chunks' increments, the
    state's walk, the per-chunk readout) is the plain chunked scan."""
    ins = [torch.from_numpy(a).double() for a in _arrays(*shape, seed=1)]
    y, state = ssd_fwd_route(*ins, rounded=False)
    want_y, want_state = mamba2_ssd_plain(*ins)
    assert y.shape == want_y.shape and state.shape == want_state.shape
    assert _normwise(y, want_y) <= NORMWISE
    assert _normwise(state, want_state) <= NORMWISE


@pytest.mark.parametrize("shape", ZAMBA)
def test_route_rounding_within_gate_of_plain(shape):
    """At bf16 with the route's rounding points, y and the f32 final state
    within the card's gate of the plain version on the same inputs."""
    ins = _torch(_arrays(*shape, seed=2), torch.bfloat16)
    y, state = ssd_fwd_route(*ins)
    want_y, want_state = mamba2_ssd_plain(*ins)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert _excess(y, want_y, GATE) <= GATE
    assert _excess(state, want_state, GATE) <= GATE


def _jax(arrays):
    return [jnp.asarray(a, jnp.bfloat16 if i in LOW else jnp.float32)
            for i, a in enumerate(arrays)]


@pytest.mark.parametrize("shape", [(1, 64, 2, 64, 1, 64),
                                   (2, 128, 2, 64, 2, 64),
                                   (1, 192, 3, 64, 1, 64),
                                   (1, 320, 2, 64, 2, 64),
                                   (1, 512, 2, 64, 1, 64),
                                   (1, 576, 2, 64, 1, 64)])
def test_route_rounding_within_jax_tolerance(shape):
    """Against the Pallas kernel in interpret mode and the JAX reference
    ``ssd_ref`` on the same bf16 x, B, C: within the SSD bf16 tolerance."""
    arrays = _arrays(*shape, seed=3)
    y, state = ssd_fwd_route(*_torch(arrays, torch.bfloat16))
    j = _jax(arrays)
    for jy, jstate in (jops.mamba2_ssd(*j, chunk=64, interpret=True),
                       jref.ssd_ref(*j)):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(jy, np.float32),
                                   atol=JAX_TOL, rtol=JAX_TOL)
        np.testing.assert_allclose(state.numpy(),
                                   np.asarray(jstate, np.float32),
                                   atol=JAX_TOL, rtol=JAX_TOL)


# chip_smoke.SSD_SHAPES and the card tests' shapes, with the route each
# takes in bf16 on aligned tensors
ROUTES = [((4, 512, 112, 64, 1, 64), "warpgroup"),   # zamba2's serve shape
          ((1, 512, 112, 64, 1, 64), "warpgroup"),   # B H = 112
          ((1, 576, 2, 64, 1, 64), "warpgroup"),     # 9 chunks
          ((2, 1024, 4, 64, 2, 64), "warpgroup"),    # 16 chunks, G = 2
          ((1, 640, 2, 64, 1, 64), "warpgroup"),     # 10 chunks
          ((1, 512, 64, 64, 1, 64), "warpgroup"),    # B H = 64
          ((2, 192, 8, 64, 1, 64), "warpgroup"),     # 3 chunks
          ((2, 128, 8, 64, 2, 64), "warpgroup"),     # G = 2: an index only
          ((1, 64, 3, 64, 1, 64), "warpgroup"),      # one chunk
          ((1, 64, 1, 64, 1, 64), "warpgroup"),      # one head
          ((4, 100, 112, 64, 1, 64), "mma.sync"),    # chunk 50
          ((2, 100, 2, 64, 1, 64), "mma.sync"),      # chunk 50, few heads
          ((1, 50, 2, 64, 1, 64), "mma.sync"),       # chunk 50, T = chunk
          ((1, 100, 3, 16, 1, 8), "mma.sync"),
          ((2, 128, 4, 32, 2, 16), "mma.sync"),
          ((1, 128, 2, 64, 1, 32), "mma.sync"),      # N = 32
          ((1, 128, 2, 32, 1, 64), "mma.sync"),      # P = 32
          ((2, 64, 2, 128, 1, 128), "mma.sync")]


@pytest.mark.parametrize("shape,route", ROUTES)
def test_fwd_route_by_shape(shape, route):
    """The route by dtype and shape alone: bf16 at N = P = chunk = 64
    takes the warpgroup kernel, whatever B, H, G and the number of chunks;
    other bf16 shapes mma.sync; f32 the CUDA cores."""
    B, T, H, P, G, N = shape
    x = torch.zeros(B, T, H, P, dtype=torch.bfloat16)
    Bm = torch.zeros(B, T, G, N, dtype=torch.bfloat16)
    assert mamba2_ssd.fwd_route(x, Bm, Bm) == route
    assert mamba2_ssd.fwd_route(x.float(), Bm.float(),
                                Bm.float()) == "cuda-cores"


def test_fwd_route_of_an_unaligned_view_is_mma_sync():
    """A view whose data is not 16-byte aligned cannot be a TMA map's."""
    flat = torch.zeros(1 * 64 * 2 * 64 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(1, 64, 2, 64)
    Bm = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
    assert mamba2_ssd.fwd_route(x, Bm, Bm) == "mma.sync"
    assert mamba2_ssd.fwd_route(x.clone(), Bm, Bm) == "warpgroup"
    big = torch.zeros(1 * 64 * 112 * 64 + 1, dtype=torch.bfloat16)
    xb = big[1:].view(1, 64, 112, 64)
    assert mamba2_ssd.fwd_route(xb, Bm, Bm) == "mma.sync"
    assert mamba2_ssd.fwd_route(xb.clone(), Bm, Bm) == "warpgroup"
    flat_b = torch.zeros(64 * 64 + 4, dtype=torch.bfloat16)
    Cm = flat_b[4:].view(1, 64, 1, 64)
    assert mamba2_ssd.fwd_route(x.clone(), Bm, Cm) == "mma.sync"


SPLITS = [((1, 128, 2, 64, 1, 64), 64), ((2, 320, 2, 64, 2, 64), 192),
          ((1, 512, 3, 64, 1, 64), 256), ((1, 576, 2, 64, 1, 64), 512)]


@pytest.mark.parametrize("shape,cut", SPLITS)
def test_route_split_at_a_chunk_carries_the_state(shape, cut):
    """The walk is the same whether a sequence comes in one call or in two
    cut at a chunk boundary, the second from the first's final state (as
    prefill hands its state on): equal bits at the route's rounding."""
    x, dt, A, Bm, Cm, s0 = _torch(_arrays(*shape, seed=4), torch.bfloat16)
    y, state = ssd_fwd_route(x, dt, A, Bm, Cm, s0)
    y1, s1 = ssd_fwd_route(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                           Cm[:, :cut], s0)
    y2, s2 = ssd_fwd_route(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                           Cm[:, cut:], s1)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(s2, state)
