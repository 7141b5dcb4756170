"""Causal flash attention forward: CUDA kernel wrapper and plain version.

    out[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h] / √hd, t ≤ s) @ v[b, t, h]
    lse[b, s, h] = log Σ_{t ≤ s} exp(q · k / √hd)

for q, k, v of shape (B, S, H, hd) (MHA: kv already repeated to H heads),
with an online softmax over kv tiles and fp32 running (acc, m, l). Replaces
the Pallas kernel ``kernels/flash_attention.py::flash_attention`` of the
JAX package (forward ``_flash_fwd_kernel``); the CUDA source, with its
bound and design, is ``csrc/flash_attention.cu``. bf16 inputs (the serve
path) run on the tensor cores, with P rounded to bf16 as the operand of
P·V; f32 inputs keep an f32 CUDA-core kernel.

:func:`flash_attention` launches the kernel for CUDA tensors and takes
:func:`flash_attention_plain` only for CPU tensors. The plain version is
the same tiled online softmax in PyTorch; with ``block_q = block_k`` equal
to the JAX reference's chunk it is ``models/attention.py::_flash_fwd_impl``.
Any sequence length works: the last tile is short, and the causal skip is
derived from token positions, never from tile indices.
"""

from __future__ import annotations

import collections
import ctypes
import math
import threading
from typing import Tuple

import torch

from . import refuse_grad

BLOCK = 64             # the plain version's q and kv tile (rows)
MAX_HEAD_DIM = 160     # the kernels' largest head dim (stablelm-12b's)
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_launcher = None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block_q: int = BLOCK, block_k: int = BLOCK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (out (B,S,H,hd) in q's dtype, lse (B,S,H)
    f32). Inputs are upcast to f32 (bf16 products are exact in f32, as
    with the reference's ``preferred_element_type``); kv tiles that start
    after a q tile's last position are skipped."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(B, S, H, hd, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, S, H, dtype=torch.float32, device=q.device)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        qi = qf[:, q0:q1]
        qpos = torch.arange(q0, q1, device=q.device)
        acc = torch.zeros(B, q1 - q0, H, hd, dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, q1 - q0, H), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(B, q1 - q0, H, dtype=torch.float32, device=q.device)
        for k0 in range(0, q1, block_k):
            k1 = min(k0 + block_k, S)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kf[:, k0:k1]) * scale
            kpos = torch.arange(k0, k1, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1).permute(0, 2, 1))
            p = torch.exp(s - m_new.permute(0, 2, 1)[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1).permute(0, 2, 1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", p, vf[:, k0:k1])
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, q0:q1] = acc / l[..., None]
        lse[:, q0:q1] = m + torch.log(l)
    return out.to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not all(isinstance(a, torch.Tensor) for a in (q, k, v)):
        raise TypeError("flash_attention takes torch tensors")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention takes q, k, v of one (B, S, H, "
                         f"hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= q.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims 1..{MAX_HEAD_DIM},"
                         f" got {q.shape[3]}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"inputs on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")


def _load():
    global _launcher
    if _launcher is None:
        from ._build import load
        fn = load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def build() -> None:
    """Build (or load) the CUDA library now rather than at first launch."""
    _load()


def kernel_info(hd: int, dtype: torch.dtype) -> dict:
    """Registers, shared memory and blocks an SM of the compiled kernel
    that ``dtype`` takes at head dim ``hd`` (``_build.kernel_info``; needs
    the card)."""
    from ._build import kernel_info as info
    return info("flash_attention", hd, _DTYPES[dtype])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, H, hd), float32 or bfloat16 → (out (B,S,H,hd) in
    q's dtype, lse (B,S,H) float32).

    CUDA tensors launch the kernel on the current stream (one launch,
    counted in ``flash_attention.launches``, its (B, S, H, hd) counted in
    ``flash_attention.shapes``); CPU tensors take the plain version.
    Anything else raises, and so does the CUDA route when grad mode is on
    and an input requires grad (it has no backward yet)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    refuse_grad("flash_attention", q, k, v)
    B, S, H, hd = q.shape
    launch = _load()
    out = torch.empty_like(q)
    lse = torch.empty(B, S, H, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), B, S, H, hd,
                     _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        flash_attention.launches += 1
        flash_attention.shapes[(B, S, H, hd)] += 1
    return out, lse


flash_attention.launches = 0
flash_attention.shapes = collections.Counter()
