"""Attention: causal flash attention for training and prefill + the
decode path.

Training and prefill call
:func:`repro_torch.kernels.flash_attention.flash_attention`: the CUDA
kernel for CUDA tensors, its plain version (the JAX package's chunked
online softmax, ``models/attention.py::_flash_fwd_impl``) for CPU
tensors; under grad its backward (FlashAttention-2, recomputed from the
saved lse) is the backward kernel or its plain version the same way.
Callers pass kv already repeated to the query head count. Decode attends one query against a (B, S, Hkv, hd)
cache with a length mask.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..kernels.flash_attention import NEG_INF, flash_attention
from . import pspec_ctx
from .pspec_ctx import constrain


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """One query position against a KV cache.

    q (B, 1, Hq, hd); k_cache, v_cache (B, S, Hkv, hd); ``length`` — an
    int or (B,) tensor of valid cache slots. Under an activation context
    each device attends its own batch rows and heads (the cache's
    sequence gathered where it is sharded)."""
    c = pspec_ctx.active()
    if c is not None and pspec_ctx.is_dtensor(q):
        tp_ok = q.shape[2] % c.tp_size == 0 and k_cache.shape[2] % \
            c.tp_size == 0
        spec = ("dp" if q.shape[0] % c.dp_size == 0 else None, None,
                "tp" if tp_ok else None, None)
        return pspec_ctx.local(
            lambda a, k, v: _decode_attention(a, k, v, length),
            in_specs=[spec] * 3, out_specs=spec)(q, k_cache, v_cache)
    return _decode_attention(q, k_cache, v_cache, length)


def _decode_attention(q, k_cache, v_cache, length):
    B, _one, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * (
        1.0 / math.sqrt(hd))
    length = torch.as_tensor(length, device=q.device)
    if length.dim() == 0:
        length = length.expand(B)
    valid = torch.arange(S, device=q.device)[None] < length[:, None]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, hd).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal self-attention for prefill: the flash kernel's output.

    q, k, v: (B, S, H, hd) with kv already repeated to H (MHA view).
    Under an activation context the kernel's operands and output lie
    batch on the data axes, heads on the model axis (where JAX pins the
    reference's accumulators)."""
    q, k, v = (constrain(t, "dp", None, "tp", None) for t in (q, k, v))
    return constrain(flash_attention(q, k, v)[0], "dp", None, "tp", None)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, length: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (B, 1, Hkv, hd) new entries at position ``length``.

    In place: the JAX reference returns updated copies
    (``dynamic_update_slice``); here the one new slot is written into the
    caller's cache, which the decode loop owns, so a decode step copies no
    cache. Returns the same two tensors."""
    k_cache[:, length:length + 1].copy_(k_new)
    v_cache[:, length:length + 1].copy_(v_new)
    return k_cache, v_cache
