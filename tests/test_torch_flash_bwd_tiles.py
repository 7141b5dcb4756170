"""The bf16 flash backward's wgmma kernels, emulated on the CPU at their
own tiles.

``csrc/flash_attention_bwd.cu`` runs the backward of bf16 inputs that a
TMA tensor map describes (hd % 8 == 0, hd <= 128) in two wgmma kernels:

- dk/dv: a block owns 128 kv rows, 64 a consumer warpgroup, and walks
  64-row q tiles (causal: from the tile holding the block's first kv row;
  full: from tile 0). A warpgroup skips a tile whose pairs all lie above
  the diagonal. It forms Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, Pᵀ and dSᵀ in f32, and
  adds Pᵀ·dO to dV and dSᵀ·Q to dK with Pᵀ and dSᵀ rounded to bf16 as
  operands.
- dq: a block owns 128 q rows, 64 a warpgroup, and walks 64-row kv tiles
  (causal: up to the warpgroup's last row; full: all of them), adding
  dS·K with dS rounded to bf16.

Masks come from token positions (kpos <= qpos, both < S), never from tile
indices. This file copies that schedule and rounding into PyTorch (the
emulation lives here, not in the port) and holds it, in both modes, to the
port's plain version (``flash_attention_bwd_plain``) within 1e-2, the gate
``chip_smoke.py`` holds the kernels to on the card, and to JAX: causal to
``jax.vjp`` through ``src/repro/models/attention.py``'s custom_vjp
(``flash_reference``, the FlashAttention-2 pairs scan that the JAX
kernel's backward runs), ``causal=False`` to ``jax.vjp`` of
``attention_ref(causal=False)`` (the JAX kernel's backward ignores
``causal=False``: ROADMAP.md C15), within 2e-2 (the bf16 gradient
tolerance of ``tests/test_torch_tensor_core_rounding.py``). Inputs come
from numpy with a seed, at small B·H.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)

BLOCK_ROWS, HALF, TILE = 128, 64, 64   # a block, a warpgroup, a walked tile
GATE, JAX_TOL = 1e-2, 2e-2
# ragged S on both sides of the 64- and 128-row edges, at the train paths'
# head dims (32, 112, 128) and 64
SHAPES = [(2, 1, 2, 32), (2, 65, 2, 32), (1, 100, 2, 64), (1, 129, 2, 112),
          (1, 300, 2, 128)]


def dkdv_walk(S: int, causal: bool):
    """(kv rows, q rows) of every product the dk/dv kernel runs: a
    warpgroup's 64 kv rows of a 128-row block against one q tile."""
    for k0 in range(0, S, BLOCK_ROWS):
        q_first = k0 if causal else 0
        for kmin in range(k0, min(k0 + BLOCK_ROWS, S), HALF):
            for q0 in range(q_first, S, TILE):
                if causal and kmin > q0 + TILE - 1:
                    continue
                yield (kmin, min(kmin + HALF, S)), (q0, min(q0 + TILE, S))


def dq_walk(S: int, causal: bool):
    """(q rows, kv rows) of every product the dq kernel runs: a
    warpgroup's 64 q rows of a 128-row block against one kv tile."""
    for q0 in range(0, S, BLOCK_ROWS):
        for qmin in range(q0, min(q0 + BLOCK_ROWS, S), HALF):
            end = min(S, qmin + HALF) if causal else S
            for k0 in range(0, end, TILE):
                yield (qmin, min(qmin + HALF, S)), (k0, min(k0 + TILE, S))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _p_and_ds(s, dp, lse, delta, qpos, kpos, causal, scale):
    """P and dS of raw scores s = q·k and dp = dO·v, both (B, H, nq, nk),
    masked from token positions."""
    p = torch.exp(s * scale - lse)
    if causal:
        p = torch.where(kpos[None, :] <= qpos[:, None], p,
                        torch.zeros_like(p))
    return p, p * (dp - delta) * scale


def flash_bwd_tiles(q, k, v, out, lse, dout, causal=True):
    """(dq, dk, dv) in bf16 as the wgmma kernels compute them: their walks,
    their masks, Pᵀ, dSᵀ and dS rounded to bf16 as operands, f32 sums."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    delta = (dof * out.float()).sum(-1)
    rows = lambda t, a, b: t[:, a:b].permute(0, 2, 1)[..., None]  # noqa
    dq = torch.zeros(B, S, H, hd)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for (k0, k1), (q0, q1) in dkdv_walk(S, causal):
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, q0:q1], kf[:, k0:k1])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, q0:q1], vf[:, k0:k1])
        p, ds = _p_and_ds(s, dp, rows(lse, q0, q1), rows(delta, q0, q1),
                          torch.arange(q0, q1), torch.arange(k0, k1), causal,
                          scale)
        dv[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", _bf16(p),
                                     dof[:, q0:q1])
        dk[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", _bf16(ds),
                                     qf[:, q0:q1])
    for (q0, q1), (k0, k1) in dq_walk(S, causal):
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, q0:q1], kf[:, k0:k1])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, q0:q1], vf[:, k0:k1])
        _, ds = _p_and_ds(s, dp, rows(lse, q0, q1), rows(delta, q0, q1),
                          torch.arange(q0, q1), torch.arange(k0, k1), causal,
                          scale)
        dq[:, q0:q1] += torch.einsum("bhqk,bkhd->bqhd", _bf16(ds),
                                     kf[:, k0:k1])
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _inputs(shape, causal, seed=31):
    """bf16 q, k, v ~ N(0, 1) and dout from the next seed (numpy); out and
    lse from the port's forward on the CPU, as the card hands them over."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(4)]
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in arrays)
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    return arrays, (q, k, v, out, lse, dout)


def _excess(got, ref, tol):
    """max(|got - ref| - tol·|ref|): within atol = rtol = tol iff <= tol."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() - tol * ref.abs()).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 300])
def test_walks_cover_every_pair_once(S, causal):
    """Each kernel's walk runs every (q, kv) pair the mode needs (kpos <=
    qpos when causal, every pair when not) exactly once; the causal walks
    run no product all of whose pairs lie above the diagonal."""
    need = np.tril(np.ones((S, S), int)) if causal else np.ones((S, S), int)
    for walk, swap in ((dkdv_walk, True), (dq_walk, False)):
        seen = np.zeros((S, S), int)
        for a, b in walk(S, causal):
            (q0, q1), (k0, k1) = (b, a) if swap else (a, b)
            seen[q0:q1, k0:k1] += 1
            assert need[q0:q1, k0:k1].any()
        assert ((seen == 1) | (need == 0)).all() and (seen <= 1).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_within_gate_of_plain(shape, causal):
    """The wgmma kernels' tiles and rounding keep dq, dk and dv within the
    card's 1e-2 of the plain version in both modes."""
    _, args = _inputs(shape, causal)
    got = flash_bwd_tiles(*args, causal=causal)
    want = flash_attention_bwd_plain(*args, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _excess(a, b, GATE) <= GATE


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_within_jax_grad_tolerance(shape, causal):
    """Against ``jax.vjp`` on the same bf16 q, k, v and cotangent: causal
    through the custom_vjp of ``models/attention.py`` (its FlashAttention-2
    backward), ``causal=False`` of ``attention_ref`` (C15), within 2e-2."""
    arrays, args = _inputs(shape, causal)
    got = flash_bwd_tiles(*args, causal=causal)
    S = shape[1]

    @jax.jit
    def grads(q, k, v, dout):
        if causal:
            fn = lambda a, b, c: jattn.flash_reference(  # noqa: E731
                a, b, c, min(S, 64))
        else:
            fn = lambda a, b, c: jref.attention_ref(  # noqa: E731
                a, b, c, causal=False)
        _, vjp = jax.vjp(fn, q, k, v)
        return vjp(dout)

    want = grads(*(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=JAX_TOL,
                                   rtol=JAX_TOL)
