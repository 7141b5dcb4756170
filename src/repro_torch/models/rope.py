"""Rotary position embeddings: standard, partial-2d (ChatGLM), M-RoPE (Qwen2-VL).

All variants are pure functions ``(q_or_k, positions, cfg) -> rotated`` over
tensors shaped ``(B, S, H, hd)``; computation in fp32, cast back to the input
dtype (rope in bf16 loses long-context precision).
"""

from __future__ import annotations

import torch

from .config import ModelConfig


def _rotate(x: torch.Tensor, positions: torch.Tensor, dim: int,
            theta: float) -> torch.Tensor:
    """Rotate the first ``dim`` channels of the last axis.

    positions: (B, S) integer. x: (B, S, H, hd).
    """
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]                 # (B,S,1,half)
    sin = torch.sin(angles)[:, :, None, :]
    x_rot, x_pass = x[..., :dim], x[..., dim:]
    x1f = x_rot[..., :half].float()
    x2f = x_rot[..., half:].float()
    out1 = x1f * cos - x2f * sin
    out2 = x2f * cos + x1f * sin
    rotated = torch.cat([out1, out2], dim=-1).to(x.dtype)
    if dim < x.shape[-1]:
        return torch.cat([rotated, x_pass], dim=-1)
    return rotated


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Dispatch on ``cfg.rope_variant``.

    * ``standard`` — rotate the full head dim.
    * ``2d`` — ChatGLM RoPE: rotate only the first half of the head dim.
    * ``mrope`` — Qwen2-VL multimodal RoPE: positions is (B, 3, S); the
      head dim is split into three sections, each rotated by its own
      position stream (equal thirds rounded to even, remainder first).
    * ``none`` — identity.
    """
    hd = x.shape[-1]
    variant = cfg.rope_variant
    if variant == "none":
        return x
    if variant == "standard":
        return _rotate(x, positions, hd, cfg.rope_theta)
    if variant == "2d":
        return _rotate(x, positions, hd // 2, cfg.rope_theta)
    if variant == "mrope":
        third = (hd // 3) // 2 * 2
        sections = (hd - 2 * third, third, third)
        outs = []
        start = 0
        for i, sec in enumerate(sections):
            piece = x[..., start:start + sec]
            outs.append(_rotate(piece, positions[:, i], sec, cfg.rope_theta))
            start += sec
        return torch.cat(outs, dim=-1)
    raise ValueError(f"unknown rope variant {variant!r}")


def default_positions(batch: int, seq: int, cfg: ModelConfig,
                      offset: int = 0, device=None) -> torch.Tensor:
    """Positions for text-only inputs (mrope degenerates to equal streams)."""
    pos = torch.arange(offset, offset + seq, dtype=torch.int32,
                       device=device).expand(batch, seq)
    if cfg.rope_variant == "mrope":
        return pos[:, None, :].expand(batch, 3, seq)
    return pos
