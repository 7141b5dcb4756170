"""Mamba-2 (SSD) block — the backbone of zamba2-7b.

State-space duality formulation (Dao & Gu, 2024): per head, a scalar
data-dependent decay ``a_t = exp(Δt·A)`` and rank-1 input ``Δt·B_t x_t``
drive the state ``h_t = a_t h_{t-1} + Δt_t B_t x_tᵀ`` with readout
``y_t = C_tᵀ h_t + D·x_t``.

Prefill and training run the *chunked* SSD scan through
:func:`repro_torch.kernels.mamba2_ssd.mamba2_ssd`: the CUDA kernel for CUDA
tensors, its plain version (the JAX package's ``ssd_chunked``, a loop over
chunks carrying the (H, N, P) state) for CPU tensors; under grad its
``autograd.Function`` takes the backward kernel (or the plain backward)
to x, dt, A, B and C through the contiguous copies below. Decode is the
O(1) recurrence plus the causal-conv ring state.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.mamba2_ssd import mamba2_ssd
from .config import ModelConfig
from .mlp import normal, rms_norm
from .pspec_ctx import constrain

__all__ = ["N_GROUPS", "dims", "init_mamba_layer", "ssd_decode",
           "causal_conv", "mamba_block", "mamba_decode", "init_state"]

N_GROUPS = 1  # B/C projection groups (zamba2 uses small group counts)


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim P, state N)."""
    d_inner = cfg.d_inner
    P = cfg.ssm_head_dim
    return d_inner, d_inner // P, P, cfg.ssm_state


def init_mamba_layer(gen: Optional[torch.Generator], cfg: ModelConfig,
                     n_layers: int, dtype: torch.dtype,
                     device: torch.device) -> Dict:
    """Input projections split per segment (z | x | B | C | dt), the JAX
    package's layout; stacked on a leading layer axis."""
    D = cfg.d_model
    d_inner, H, P, N = dims(cfg)
    conv_dim = d_inner + 2 * N_GROUPS * N
    L = (n_layers,) if n_layers else ()
    s_in = math.sqrt(1.0 / D)

    def full(shape, value, dt=torch.float32):
        return torch.full(L + shape, value, dtype=dt, device=device)

    return {
        "ln": full((D,), 1.0),
        "wz": normal(L + (D, d_inner), s_in, gen, device, dtype),
        "wx": normal(L + (D, d_inner), s_in, gen, device, dtype),
        "wb": normal(L + (D, N_GROUPS * N), s_in, gen, device, dtype),
        "wc": normal(L + (D, N_GROUPS * N), s_in, gen, device, dtype),
        "wdt": normal(L + (D, H), s_in, gen, device, dtype),
        "conv_w": normal(L + (cfg.ssm_conv, conv_dim), 0.2, gen, device,
                         dtype),
        "conv_b": full((conv_dim,), 0.0, dtype),
        "A_log": full((H,), 0.0),                 # A = -exp(A_log)
        "D": full((H,), 1.0),
        "dt_bias": full((H,), -2.0),
        "out_norm": full((d_inner,), 1.0),
        "out_proj": normal(L + (d_inner, D), math.sqrt(1.0 / d_inner), gen,
                           device, dtype),
    }


def ssd_decode(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step SSD. x: (B,H,P); dt: (B,H); Bm,Cm: (B,G,N); state (B,H,N,P)."""
    hpg = x.shape[1] // Bm.shape[1]
    xf, dtf = x.float(), dt.float()
    Bh = Bm.float().repeat_interleave(hpg, dim=1)         # (B,H,N)
    Ch = Cm.float().repeat_interleave(hpg, dim=1)
    a = torch.exp(dtf * A[None])                           # (B,H)
    state = (state * a[..., None, None]
             + torch.einsum("bhn,bhp->bhnp", Bh * dtf[..., None], xf))
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    return y.to(x.dtype), state


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                ring: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,T,C); w: (K,C); ring: (B,K-1,C)."""
    K, T = w.shape[0], x.shape[1]
    xp = torch.cat([ring.to(x.dtype), x], dim=1)
    out = xp[:, 0:T] * w[0][None, None]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i][None, None]
    new_ring = xp[:, -(K - 1):] if K > 1 else ring
    return F.silu(out + b[None, None]), new_ring


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    d_inner, H, P, N = dims(cfg)
    lead = xbc.shape[:-1]
    xs = xbc[..., :d_inner].reshape(*lead, H, P)
    Bm = xbc[..., d_inner:d_inner + N_GROUPS * N].reshape(*lead, N_GROUPS, N)
    Cm = xbc[..., d_inner + N_GROUPS * N:].reshape(*lead, N_GROUPS, N)
    return xs, Bm, Cm


def mamba_block(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Dict,
                ) -> Tuple[torch.Tensor, Dict]:
    """One Mamba2 layer. x: (B,T,D)."""
    B, T, _ = x.shape
    d_inner = cfg.d_inner
    x = constrain(x, "dp", "tp" if cfg.sp else None, None)
    h = constrain(rms_norm(x, p["ln"], cfg.norm_eps), "dp", None, None)
    # under an activation context the projections (and so their
    # gradients) lie batch on the data axes, features on the model axis
    z = constrain(h @ p["wz"], "dp", None, "tp")
    xbc = torch.cat([constrain(h @ p["wx"], "dp", None, "tp"),
                     constrain(h @ p["wb"], "dp", None, None),
                     constrain(h @ p["wc"], "dp", None, None)], dim=-1)
    dt_raw = constrain(h @ p["wdt"], "dp", None, "tp")
    xbc, conv_state = causal_conv(xbc, p["conv_w"], p["conv_b"],
                                  state["conv"])
    xs, Bm, Cm = _split_xbc(xbc, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    # the kernel takes contiguous operands: x, B and C are column slices of
    # the conv output
    y, ssm_state = mamba2_ssd(xs.contiguous(), dt, A, Bm.contiguous(),
                              Cm.contiguous(), state["ssm"].contiguous())
    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, T, d_inner)
    # gated RMSNorm (mamba2's norm-before-out-proj, gated by z)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    out = constrain(y @ p["out_proj"], "dp", "tp" if cfg.sp else None, None,
                    pin_grad=False)
    return x + out, {"conv": conv_state, "ssm": ssm_state}


def mamba_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Dict,
                 ) -> Tuple[torch.Tensor, Dict]:
    """One token. x: (B,1,D)."""
    B = x.shape[0]
    d_inner = cfg.d_inner
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z = (h @ p["wz"])[:, 0]
    xbc = torch.cat([h @ p["wx"], h @ p["wb"], h @ p["wc"]], dim=-1)[:, 0]
    dt_raw = (h @ p["wdt"])[:, 0]
    # conv ring buffer: shift in the new column
    ring = state["conv"]                                  # (B, K-1, C)
    K = p["conv_w"].shape[0]
    window = torch.cat([ring.to(x.dtype), xbc[:, None]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc_t = F.silu(conv_out)
    new_ring = window[:, 1:] if K > 1 else ring
    xs, Bm, Cm = _split_xbc(xbc_t, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None])
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssd_decode(xs, dt, A, Bm, Cm, state["ssm"])
    y = y + xs * p["D"].to(y.dtype)[None, :, None]
    y = y.reshape(B, d_inner)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None]
    return x + out, {"conv": new_ring, "ssm": ssm_state}


def init_state(cfg: ModelConfig, batch: int, device: torch.device,
               dtype: torch.dtype = torch.float32) -> Dict:
    d_inner, H, P, N = dims(cfg)
    conv_dim = d_inner + 2 * N_GROUPS * N
    return {
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, conv_dim, dtype=dtype,
                            device=device),
        "ssm": torch.zeros(batch, H, N, P, dtype=torch.float32,
                           device=device),
    }
