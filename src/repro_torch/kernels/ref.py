"""Naive PyTorch oracles for the kernels (quadratic attention, step-by-step
recurrences), independent of the chunked formulations in
:mod:`repro_torch.models` and of the kernels' plain versions, so tests hold
both against one ground truth.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Attention, causal or full (every query sees every key). q,k,v:
    (B, S, H, hd) → (B, S, H, hd). fp32 softmax."""
    S, hd = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(hd))
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def wkv_ref(r, k, v, w, u, state0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 WKV, step-by-step. r,k,v,w: (B,T,H,N); u: (H,N);
    state0: (B,H,N,N)."""
    state = state0.float()
    uf = u.float()[None, ..., None]
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        kv = torch.einsum("bhn,bhm->bhnm", kt, vt)
        outs.append(torch.einsum("bhn,bhnm->bhm", rt, state + uf * kv))
        state = state * wt[..., None] + kv
    return torch.stack(outs, dim=1).to(r.dtype), state


def ssd_ref(x, dt, A, Bm, Cm, state0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD, step-by-step. x: (B,T,H,P); dt: (B,T,H); A: (H,);
    Bm,Cm: (B,T,G,N); state0: (B,H,N,P)."""
    H = x.shape[2]
    hpg = H // Bm.shape[2]
    state = state0.float()
    ys = []
    for t in range(x.shape[1]):
        xt = x[:, t].float()
        dtt = dt[:, t].float()
        Bh = Bm[:, t].float().repeat_interleave(hpg, dim=1)
        Ch = Cm[:, t].float().repeat_interleave(hpg, dim=1)
        a = torch.exp(dtt * A.float()[None])
        state = (state * a[..., None, None]
                 + torch.einsum("bhn,bhp->bhnp", Bh * dtt[..., None], xt))
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch, state))
    return torch.stack(ys, dim=1).to(x.dtype), state
