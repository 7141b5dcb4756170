"""The SSD backward's cluster route, emulated on the CPU in its own order of
sums.

``csrc/mamba2_ssd_bwd.cu`` runs the bf16 backward at N = P = chunk = 64
with one B/C group and at most 8 chunks (zamba2's train path) as one thread
block cluster per (batch, group of ``cluster_heads(H)`` heads), a block per
chunk:

- each block forms its chunk's increments U_k = (B ∘ w)ᵀ·x and V_k = (C ∘
  e^{cum})ᵀ·dy, B ∘ w and C ∘ e^{cum} split into bf16 hi + lo;
- the chunk states go from block to block, in chunk order: block k takes
  S_k from block k − 1 (state0 at k = 0) and hands on S_{k+1} = e^{cum_L}
  S_k + U_k; dS' goes the other way, dS'_{k−1} = e^{cum_L} dS'_k + V_k
  from dstate_T (or zeros) at the last chunk, and block 0's is dstate0;
- each block forms its chunk's gradient from S_k and dS'_k (both split)
  and M and dG (split), the rows-s products reading the same split M and
  dG transposed;
- dB and dC of a block's heads add up in f32 in head order, one partial
  sum a group; the fixed-order sums then add the groups in order.

This file writes that schedule in PyTorch (the emulation lives here, not
in the port) and holds it to the port's plain version
``mamba2_ssd_bwd_plain``: in f64 without rounding within 1e-10, and at
bf16 with the route's rounding within 1e-2, the gate ``chip_smoke.py``
holds the kernel to on the card; and to ``jax.grad`` of
``repro.models.mamba2.ssd_chunked`` within 6e-2, the SSD bf16 tolerance of
``tests/test_torch_scan_bwd_rounding.py``. Widths are zamba2's (P = N =
64, chunk 64, T = 512) at a few heads; inputs come from numpy with a seed.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba2_ssd
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_bwd_plain, pick_chunk
from test_torch_scan_bwd_rounding import (SSD_JAX_TOL, SSD_LOW, SSD_NAMES,
                                          _excess, _normwise, _parts,
                                          _product, _ssd_arrays,
                                          _ssd_jax_grads, _torch)

GATE = 1e-2
NORMWISE = 1e-10
ZAMBA = (1, 512, 4, 64, 1, 64)      # zamba2's widths at 4 heads


def ssd_bwd_cluster(x, dt, A, Bm, Cm, state0, dy, dstate_T=None, heads=1,
                    mode="split", chunk=64):
    """``mamba2_ssd_bwd_plain`` in the cluster route's order: the chunk
    increments, the states handed on block by block in chunk order, each
    chunk's gradient, dB and dC summed over ``heads`` heads a block in head
    order and then over the groups in order; f32 operands as
    ``_parts(·, mode)``. f64 inputs stay f64."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[3]
    assert Bm.shape[2] == 1 and H % heads == 0
    c = pick_chunk(T, chunk)
    K = T // c
    wt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xk, dyk = (a.to(wt).reshape(Bsz, K, c, H, P) for a in (x, dy))
    dtk = dt.to(wt).reshape(Bsz, K, c, H)
    Bk, Ck = (a.to(wt).reshape(Bsz, K, c, N) for a in (Bm, Cm))
    Af = A.to(wt)
    op = functools.partial(_parts, mode=mode)
    cum = torch.cumsum(dtk * Af, dim=2)                   # (B, K, c, H)
    ecum = torch.exp(cum)
    last = ecum[:, :, -1]                                 # (B, K, H)
    dec = torch.exp(cum[:, :, -1:] - cum)
    w = dec * dtk
    # each block's increments
    U = _product("bkshn,bkshp->bkhnp", op(Bk[:, :, :, None] * w[..., None]),
                 [xk])
    V = _product("bkthn,bkthp->bkhnp",
                 op(Ck[:, :, :, None] * ecum[..., None]), [dyk])
    # the chain: S forwards and dS' backwards, one block to the next
    S = [state0.to(wt)]
    for k in range(K - 1):
        S.append(last[:, k, :, None, None] * S[k] + U[:, k])
    dSp = [None] * K
    dSp[K - 1] = (torch.zeros_like(S[0]) if dstate_T is None
                  else dstate_T.to(wt))
    for k in range(K - 1, 0, -1):
        dSp[k - 1] = last[:, k, :, None, None] * dSp[k] + V[:, k]
    dstate0 = last[:, 0, :, None, None] * dSp[0] + V[:, 0]
    S, dSp = torch.stack(S, 1), torch.stack(dSp, 1)      # (B, K, H, N, P)
    # rows t: G = C·Bᵀ and dM = dy·xᵀ, exact products of bf16 inputs
    tri = torch.ones(c, c, dtype=torch.bool).tril()
    Gm = torch.einsum("bktn,bksn->bkts", Ck, Bk)[:, :, None]
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
    dC = ecum[..., None] * sdy + _product("bkhts,bksn->bkthn", op(dG), [Bk])
    # rows s: the split M and dG, transposed, against dy and C
    MT, dGT = M.transpose(3, 4), dG.transpose(3, 4)
    sdx = _product("bkhnp,bkshp->bkshn", op(dSp), [xk])
    dB = w[..., None] * sdx + _product("bkhst,bktn->bkshn", op(dGT), [Ck])
    dx = (w[..., None] * _product("bkhnp,bksn->bkshp", op(dSp), [Bk])
          + _product("bkhst,bkthp->bkshp", op(MT), [dyk]))
    dW = (Bk[:, :, :, None] * sdx).sum(-1)
    Uq = F.pad(torch.cumsum(Q, 4)[..., :-1], (1, 0))
    dloga = ((Uq * tri.to(Uq.dtype)).sum(3).permute(0, 1, 3, 2)
             + torch.flip(torch.cumsum(torch.flip(
                 ecum * (Ck[:, :, :, None] * sdy).sum(-1), [2]), 2), [2])
             + F.pad(torch.cumsum(dW * w, 2)[:, :, :-1], (0, 0, 1, 0))
             + (last * (S * dSp).sum((3, 4)))[:, :, None])
    ddt = cole + dec * dW + Af * dloga
    dA = (dtk * dloga).sum((0, 1, 2))

    def grouped(a):
        """(B, K, c, H, N) summed over the heads: each group's in head
        order, then the groups' partial sums in order."""
        total = torch.zeros_like(a[..., 0, :])
        for g0 in range(0, H, heads):
            part = torch.zeros_like(total)
            for h in range(g0, g0 + heads):
                part = part + a[..., h, :]
            total = total + part
        return total.reshape(Bsz, T, 1, N)

    return (dx.reshape(Bsz, T, H, P).to(x.dtype), ddt.reshape(Bsz, T, H),
            dA, grouped(dB).to(Bm.dtype), grouped(dC).to(Cm.dtype), dstate0)


@pytest.mark.parametrize("shape,heads", [((1, 128, 2, 16, 1, 8), 2),
                                         ((2, 192, 3, 16, 1, 16), 1),
                                         ((1, 256, 4, 8, 1, 8), 2)])
def test_cluster_order_is_the_plain_backward_in_f64(shape, heads):
    """Without rounding, the chain across the cluster and the head-grouped
    sums are the plain backward, with and without dstate_T (at narrow
    widths and chunks of 64: the order, not the widths, is under test)."""
    *ins, dy, dsT = _torch(_ssd_arrays(*shape, seed=1), SSD_LOW,
                           torch.float64)
    for ds in (dsT, None):
        got = ssd_bwd_cluster(*ins, dy, ds, heads=heads, mode="exact")
        want = mamba2_ssd_bwd_plain(*ins, dy, ds)
        for name, a, b in zip(SSD_NAMES, got, want):
            assert a.shape == b.shape, name
            if b.abs().max() > 0:
                assert _normwise(a, b) <= NORMWISE, name


@pytest.mark.parametrize("with_ds", [True, False])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_cluster_split_operands_within_gate_of_plain(heads, with_ds):
    """At zamba2's widths the route's rounding, with dB and dC summed over
    1, 2 or 4 heads a block, keeps every gradient within the card's 1e-2
    of the plain version, with and without a final-state gradient (the
    train step passes none)."""
    *ins, dy, dsT = _torch(_ssd_arrays(*ZAMBA, seed=2), SSD_LOW,
                           torch.bfloat16)
    ds = dsT if with_ds else None
    got = ssd_bwd_cluster(*ins, dy, ds, heads=heads)
    want = mamba2_ssd_bwd_plain(*ins, dy, ds)
    for name, a, b in zip(SSD_NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _excess(a, b, GATE) <= GATE, (name, _excess(a, b, GATE))


def test_cluster_single_rounding_misses_the_gate():
    """The route keeps the hi + lo split (standing constraint C4): one
    bf16 rounding of each f32 operand, in the cluster's order too, takes
    dx, dB and dC past the gate."""
    *ins, dy, dsT = _torch(_ssd_arrays(*ZAMBA, seed=2), SSD_LOW,
                           torch.bfloat16)
    got = ssd_bwd_cluster(*ins, dy, dsT, heads=4, mode="round")
    want = mamba2_ssd_bwd_plain(*ins, dy, dsT)
    for name in ("dx", "dBm", "dCm"):
        i = SSD_NAMES.index(name)
        assert _excess(got[i], want[i], GATE) > GATE, name


@pytest.mark.parametrize("heads", [1, 4])
def test_cluster_split_operands_within_jax_grad_tolerance(heads):
    """Against ``jax.grad`` of the JAX chunked scan on the same bf16 x, B,
    C: within the SSD bf16 tolerance 6e-2, dA included."""
    want = _ssd_jax_grads(ZAMBA, 3)
    *ins, dy, dsT = _torch(_ssd_arrays(*ZAMBA, seed=3), SSD_LOW,
                           torch.bfloat16)
    got = ssd_bwd_cluster(*ins, dy, dsT, heads=heads)
    for name, a, b in zip(SSD_NAMES, got, want):
        np.testing.assert_allclose(a.float().numpy(), b, atol=SSD_JAX_TOL,
                                   rtol=SSD_JAX_TOL, err_msg=name)


# chip_smoke.SSD_BWD_SHAPES and tests/test_torch_gpu.py's, with the route
# each takes in bf16 on aligned tensors
ROUTES = [((4, 512, 112, 64, 1, 64), "cluster"),
          ((4, 100, 112, 64, 1, 64), "mma.sync"),     # chunk 50
          ((2, 128, 8, 64, 2, 64), "mma.sync"),       # G = 2
          ((1, 100, 3, 16, 1, 8), "mma.sync"),
          ((2, 128, 4, 32, 2, 16), "mma.sync"),
          ((2, 100, 8, 64, 2, 64), "mma.sync"),
          ((1, 100, 3, 16, 1, 5), "mma.sync"),
          ((2, 64, 2, 128, 1, 128), "mma.sync"),      # N = P = 128
          ((1, 64, 2, 64, 1, 64), "cluster"),         # one chunk
          ((2, 1024, 4, 64, 1, 64), "mma.sync")]      # 16 chunks


@pytest.mark.parametrize("shape,route", ROUTES)
def test_bwd_route_by_shape(shape, route):
    """The route by dtype and shape alone: bf16 at N = P = chunk = 64, G =
    1 and at most 8 chunks takes the cluster kernel; f32 the CUDA cores."""
    B, T, H, P, G, N = shape
    x = torch.zeros(B, T, H, P, dtype=torch.bfloat16)
    Bm = torch.zeros(B, T, G, N, dtype=torch.bfloat16)
    assert mamba2_ssd.bwd_route(x, Bm, Bm, x) == route
    assert mamba2_ssd.bwd_route(x.float(), Bm.float(), Bm.float(),
                                x.float()) == "cuda-cores"


def test_bwd_route_of_an_unaligned_view_is_mma_sync():
    """A view whose data is not 16-byte aligned cannot be a TMA map's."""
    flat = torch.zeros(1 * 64 * 2 * 64 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(1, 64, 2, 64)
    Bm = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
    assert mamba2_ssd.bwd_route(x, Bm, Bm, x) == "mma.sync"
    assert mamba2_ssd.bwd_route(x.clone(), Bm, Bm, x.clone()) == "cluster"


@pytest.mark.parametrize("H,heads", [(112, 16), (4, 4), (3, 3), (7, 7),
                                     (10, 10), (1, 1), (48, 16), (34, 2)])
def test_cluster_heads_divide_the_heads(H, heads):
    """A block walks the largest divisor of H up to 16 heads."""
    assert mamba2_ssd.cluster_heads(H) == heads
    assert H % heads == 0


def _hopper_source() -> str:
    import os
    return open(os.path.join(os.path.dirname(__file__), os.pardir, "src",
                             "repro_torch", "kernels", "csrc",
                             "hopper.cuh")).read()


def test_mma_ss_t_lists_its_accumulators_and_transposes():
    """The cluster kernel's m64n64k16 product with either operand MN-major
    (``hp::mma_ss_t<kTransA, kTransB>``): 32 accumulators %0..%31 listed
    and bound in order, descriptors %32 and %33, the scale-d predicate
    from %34 and the two transpose flags from the template's immediates."""
    import re
    text = _hopper_source()
    body = re.search(r"void mma_ss_t\(float \(&d\)\[32\](.*?)\n}", text,
                     re.S).group(1)
    asm = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"\s*\n', body))
    listed = re.search(r"\.bf16 \{([^}]*)\}", asm).group(1)
    assert [int(x) for x in re.findall(r"%(\d+)", listed)] == list(range(32))
    assert [int(x) for x in re.findall(r'"\+f"\(d\[(\d+)\]\)', body)] == \
        list(range(32))
    assert "m64n64k16" in asm and "setp.ne.b32 p, %34, 0;" in asm
    assert "}, %32, %33, p, 1, 1, %35, %36;" in asm
    assert re.search(r'"l"\(a\), "l"\(b\), "r"\(scale_d\), "n"\(kTransA\), '
                     r'"n"\(kTransB\)\);', body)


@pytest.mark.parametrize("piece", ["mapa.shared::cluster.u32",
                                   "barrier.cluster.arrive.release.aligned",
                                   "barrier.cluster.wait.acquire.aligned",
                                   "mbarrier::complete_tx::bytes.v4.f32",
                                   "mbarrier.try_wait.parity.acquire.cluster",
                                   "mbarrier.arrive.release.cluster."
                                   "shared::cluster.b64"])
def test_cluster_pieces_are_in_the_header(piece):
    """The distributed-shared-memory pieces the cluster kernel uses are
    spelt as PTX writes them (they compile only on the card)."""
    assert piece in _hopper_source()
