"""RWKV-6 (Finch): attention-free time-mix with data-dependent decay — the
backbone of rwkv6-3b.

Faithful to arXiv:2404.05892: token-shift with LoRA-modulated 5-way
interpolation, per-channel data-dependent decay ``w_t = exp(-exp(…))``, the
``u`` (bonus) in-place term, per-head WKV state of shape (head, N, N) with
N = 64, grouped-norm output gating, and squared-ReLU channel mixing.

Prefill and training run the chunked WKV through
:func:`repro_torch.kernels.rwkv6_wkv.rwkv6_wkv`: the CUDA kernel for CUDA
tensors, its plain version (the JAX package's ``wkv_chunked``, a loop over
chunks carrying the (H, N, N) state) for CPU tensors; under grad its
``autograd.Function`` takes the backward kernel (or the plain backward)
to r, k, v, w and u. Decode is the O(1) recurrence on the carried state,
in plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.rwkv6_wkv import rwkv6_wkv
from .config import ModelConfig
from .mlp import normal, rms_norm
from .pspec_ctx import constrain

HEAD_N = 64      # RWKV head size (fixed across the published family)
LORA_RANK = 32
DECAY_RANK = 64
GROUP_NORM_EPS = 64e-5


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_N


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #

def init_rwkv_layer(gen: Optional[torch.Generator], cfg: ModelConfig,
                    n_layers: int, dtype: torch.dtype,
                    device: torch.device) -> Dict:
    """The JAX package's layout, stacked on a leading layer axis; matmul
    weights drawn on ``device`` from ``gen`` in ``dtype``, the mixing,
    decay and norm leaves in f32."""
    D, F_ = cfg.d_model, cfg.d_ff
    L = (n_layers,) if n_layers else ()
    s = math.sqrt(1.0 / D)

    def w(shape, scale=s):
        return normal(L + shape, scale, gen, device, dtype)

    def full(shape, value):
        return torch.full(L + shape, value, dtype=torch.float32,
                          device=device)

    return {
        "ln1": full((D,), 1.0),
        "ln2": full((D,), 1.0),
        # 5-way token-shift mixing (w, k, v, r, g) + its LoRA
        "maa_x": full((D,), 0.0),
        "maa_wkvrg": full((5, D), 0.0),
        "maa_w1": w((D, 5 * LORA_RANK)),
        "maa_w2": w((5, LORA_RANK, D), scale=math.sqrt(1.0 / LORA_RANK)),
        # data-dependent decay
        "decay": full((D,), -6.0),
        "decay_w1": w((D, DECAY_RANK)),
        "decay_w2": w((DECAY_RANK, D), scale=math.sqrt(1.0 / DECAY_RANK)),
        "bonus": full((D,), 0.0),                # "u" / faaaa
        "wr": w((D, D)),
        "wk": w((D, D)),
        "wv": w((D, D)),
        "wg": w((D, D)),
        "wo": w((D, D)),
        "ln_x": full((D,), 1.0),                 # per-head group norm
        # channel mix
        "cmix_k": full((D,), 0.0),
        "cmix_r": full((D,), 0.0),
        "ck": w((D, F_)),
        "cv": w((F_, D), scale=math.sqrt(1.0 / F_)),
        "cr": w((D, D)),
    }


# --------------------------------------------------------------------------- #
# WKV decode step
# --------------------------------------------------------------------------- #

def wkv_decode(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step WKV. r,k,v,w: (B, H, N); state: (B, H, N, N)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    kv = torch.einsum("bhn,bhm->bhnm", kf, vf)
    out = torch.einsum("bhn,bhnm->bhm", rf, state + uf[None, ..., None] * kv)
    state = state * wf[..., None] + kv
    return out.to(r.dtype), state


# --------------------------------------------------------------------------- #
# Block application
# --------------------------------------------------------------------------- #

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` one op at a time, each rounded to x's dtype, as
    ``jax.nn.sigmoid`` computes it. (``torch.sigmoid`` rounds once and
    differs from it in the last bf16 bit on about a third of the elements;
    the bf16 decay's rounding near 1 turns such bits into percent-level
    differences of the WKV state a layer later.)"""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with :func:`sigmoid`, as ``jax.nn.silu``."""
    return x * sigmoid(x)


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shift(x)[t] = x[t-1]; position 0 gets ``last`` (carried state)."""
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _time_mix_inputs(p: Dict, x: torch.Tensor, shifted: torch.Tensor):
    """5-way LoRA-modulated token-shift interpolation → (xw, xk, xv, xr,
    xg)."""
    xx = shifted - x
    base = x + xx * p["maa_x"].to(x.dtype)
    t = constrain(torch.tanh(base @ p["maa_w1"].to(x.dtype)),  # (B,T,5R)
                  "dp", None, None)
    t = t.reshape(*base.shape[:2], 5, LORA_RANK)            # (B,T,5,R)
    deltas = torch.einsum("btfr,frd->btfd", t,
                          p["maa_w2"].to(x.dtype))          # (B,T,5,D)
    mixed = (x[:, :, None] + xx[:, :, None]
             * (p["maa_wkvrg"].to(x.dtype)[None, None] + deltas))
    # order: w, k, v, r, g
    return tuple(mixed[:, :, i] for i in range(5))


def decay(p: Dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-step decay ``exp(-exp(d))`` in (0, 1), computed in f32 (the
    double exponential)."""
    low = constrain(torch.tanh(xw.float() @ p["decay_w1"].float()),
                    "dp", None, None)
    dd = p["decay"].float() + low @ p["decay_w2"].float()
    return torch.exp(-torch.exp(dd))


def group_norm(o: torch.Tensor) -> torch.Tensor:
    """Per-head norm of (..., H, N) over N, with the population variance
    (``jnp.var``; ``torch.var`` needs ``correction=0`` for it). The scale
    ``rsqrt(var + eps)`` is taken in f32 and rounded once to o's dtype, as
    XLA computes it."""
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    return (o - mean) * torch.rsqrt(var.float() + GROUP_NORM_EPS).to(o.dtype)


def time_mix(p: Dict, x: torch.Tensor, cfg: ModelConfig,
             shift_state: torch.Tensor, wkv_state: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full time-mix block. x: (B,T,D). Returns (out, shift_state',
    wkv')."""
    B, T, D = x.shape
    H = D // HEAD_N
    shifted = _token_shift(x, shift_state)
    xw, xk, xv, xr, xg = _time_mix_inputs(p, x, shifted)

    # under an activation context the projections (and so their
    # gradients) lie batch on the data axes, features on the model axis
    r = constrain(xr @ p["wr"], "dp", None, "tp").reshape(B, T, H, HEAD_N)
    k = constrain(xk @ p["wk"], "dp", None, "tp").reshape(B, T, H, HEAD_N)
    v = constrain(xv @ p["wv"], "dp", None, "tp").reshape(B, T, H, HEAD_N)
    g = silu(constrain(xg @ p["wg"], "dp", None, "tp"))
    w = decay(p, xw).reshape(B, T, H, HEAD_N)
    u = p["bonus"].float().reshape(H, HEAD_N)
    # the decay reaches the kernel rounded to r's dtype, as in the JAX model
    out, wkv_state = rwkv6_wkv(r, k, v, w.to(r.dtype), u, wkv_state)
    out = group_norm(out).reshape(B, T, D) * p["ln_x"].to(out.dtype)
    out = out.to(x.dtype) * g
    return out @ p["wo"], x[:, -1], wkv_state


def channel_mix(p: Dict, x: torch.Tensor, shift_state: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    shifted = _token_shift(x, shift_state)
    xx = shifted - x
    xk = x + xx * p["cmix_k"].to(x.dtype)
    xr = x + xx * p["cmix_r"].to(x.dtype)
    k = torch.square(torch.relu(constrain(xk @ p["ck"], "dp", None, "tp")))
    r = constrain(xr @ p["cr"], "dp", None, None)
    return sigmoid(r) * (k @ p["cv"]), x[:, -1]


def _add_norm(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + y, rms_norm(x + y)), with the norm taken of the f32 sum before
    it is rounded to x's dtype: XLA fuses the JAX model's residual add into
    the norm's f32 upcast that way."""
    s = x.float() + y.float()
    return s.to(x.dtype), rms_norm(s, scale, eps).to(x.dtype)


def rwkv_block(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Dict,
               ) -> Tuple[torch.Tensor, Dict]:
    """One RWKV layer (time-mix + channel-mix with pre-norms)."""
    x = constrain(x, "dp", "tp" if cfg.sp else None, None)
    # the norms' outputs with their sequence gathered (token shift, matmuls)
    h = constrain(rms_norm(x, p["ln1"], cfg.norm_eps), "dp", None, None)
    tm, s1, wkv = time_mix(p, h, cfg, state["tm_shift"], state["wkv"])
    sp = "tp" if cfg.sp else None
    x, h = _add_norm(x, constrain(tm, "dp", sp, None, pin_grad=False),
                     p["ln2"], cfg.norm_eps)
    cm, s2 = channel_mix(p, constrain(h, "dp", None, None),
                         state["cm_shift"])
    x = x + constrain(cm, "dp", sp, None, pin_grad=False)
    return x, {"tm_shift": s1, "cm_shift": s2, "wkv": wkv}


def rwkv_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Dict,
                ) -> Tuple[torch.Tensor, Dict]:
    """One token through one layer, by the O(1) recurrence. x: (B,1,D)."""
    B, _, D = x.shape
    H = n_heads(cfg)
    hn = rms_norm(x, p["ln1"], cfg.norm_eps)
    shifted = state["tm_shift"][:, None].to(hn.dtype)
    xw, xk, xv, xr, xg = _time_mix_inputs(p, hn, shifted)
    r = (xr @ p["wr"]).reshape(B, H, HEAD_N)
    k = (xk @ p["wk"]).reshape(B, H, HEAD_N)
    v = (xv @ p["wv"]).reshape(B, H, HEAD_N)
    g = silu(xg @ p["wg"])
    w = decay(p, xw).reshape(B, H, HEAD_N)
    u = p["bonus"].float().reshape(H, HEAD_N)
    o, wkv_new = wkv_decode(r, k, v, w, u, state["wkv"])
    o = group_norm(o.reshape(B, 1, H, HEAD_N)).reshape(B, 1, D)
    o = o * p["ln_x"].to(o.dtype) * g
    x, h2 = _add_norm(x, o @ p["wo"], p["ln2"], cfg.norm_eps)
    cm, _ = channel_mix(p, h2, state["cm_shift"])
    x = x + cm
    return x, {"tm_shift": hn[:, -1], "cm_shift": h2[:, -1],
               "wkv": wkv_new}


def init_state(cfg: ModelConfig, batch: int, device: torch.device,
               dtype: torch.dtype = torch.float32) -> Dict:
    """Per-layer recurrent state (stacked over layers by the assembler)."""
    D = cfg.d_model
    H = n_heads(cfg)
    return {
        "tm_shift": torch.zeros(batch, D, dtype=dtype, device=device),
        "cm_shift": torch.zeros(batch, D, dtype=dtype, device=device),
        "wkv": torch.zeros(batch, H, HEAD_N, HEAD_N, dtype=torch.float32,
                           device=device),
    }
