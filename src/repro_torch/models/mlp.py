"""Norms, activations, dense MLP blocks (pure functions over param dicts)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

# the norms: one fused launch where the kernel's route takes the inputs (a
# bf16 serve path on the card), else the float32 chain
from ..kernels.rms_norm import add_rms_norm, rms_norm  # noqa: F401
from .config import ModelConfig


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}")


def gated_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """MLP: gated (SwiGLU-style) when ``wg`` is present, else plain 2-matrix."""
    if "wg" in params:
        h = activate(x @ params["wg"], cfg.act) * (x @ params["wu"])
        return h @ params["wd"]
    return activate(x @ params["wu"], cfg.act) @ params["wd"]


def normal(shape, scale: float, gen: Optional[torch.Generator],
           device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn on ``device`` from ``gen``. On the meta
    device nothing is drawn or allocated (shapes only)."""
    if device.type == "meta":
        return torch.empty(shape, device=device, dtype=dtype)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(scale)


def init_gated_mlp(gen: Optional[torch.Generator], d_model: int, d_ff: int,
                   dtype: torch.dtype, device: torch.device,
                   n_layers: int = 0, gated: bool = True) -> Dict:
    """Stacked init (leading layer axis when n_layers > 0)."""
    lead = (n_layers,) if n_layers else ()
    s_in = math.sqrt(2.0 / (d_model + d_ff))
    params = {
        "wu": normal(lead + (d_model, d_ff), s_in, gen, device, dtype),
        "wd": normal(lead + (d_ff, d_model), s_in, gen, device, dtype),
    }
    if gated:
        params["wg"] = normal(lead + (d_model, d_ff), s_in, gen, device,
                              dtype)
    return params
