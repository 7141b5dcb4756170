"""Flash attention, causal or full: CUDA kernel wrappers (forward and
backward) and their plain versions.

    out[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h] / √hd, t ∈ T(s)) @ v[b, t, h]
    lse[b, s, h] = log Σ_{t ∈ T(s)} exp(q · k / √hd)

for q, k, v of shape (B, S, H, hd) (MHA: kv already repeated to H heads),
with an online softmax over kv tiles and fp32 running (acc, m, l). T(s)
is t ≤ s with ``causal=True`` (the default, the models' attention) and
every t < S with ``causal=False`` (bidirectional attention). Replaces
the Pallas kernel ``kernels/flash_attention.py::flash_attention`` of the
JAX package (forward ``_flash_fwd_kernel``, both values of its
``causal``); the CUDA source, with its bound and design, is
``csrc/flash_attention.cu``, where ``causal`` is a template parameter.
bf16 inputs (the serve path) run on the tensor cores, with P rounded to
bf16 as the operand of P·V: those a TMA tensor map can describe (hd % 8
== 0, 16-byte aligned bases; every main-path shape) on Hopper's wgmma
kernel, the rest on the mma.sync one (:func:`route` names the kernel an
input takes); f32 inputs keep an f32 CUDA-core kernel.

The backward replaces that kernel's ``custom_vjp`` backward, which runs
``models/attention.py::_flash_bwd_impl`` (FlashAttention-2: P recomputed
from the saved lse): :func:`flash_attention_bwd` launches
``csrc/flash_attention_bwd.cu`` for CUDA tensors and takes
:func:`flash_attention_bwd_plain` for CPU tensors. Its bf16 route (the
train path) runs on the tensor cores, with P and dS rounded to bf16 as
operands; f32 keeps an f32 CUDA-core route. :func:`flash_attention`
goes through an ``autograd.Function`` when grad mode is on and an input
requires grad, so a train step's gradients flow through both kernels.
The backward's bf16 inputs a TMA tensor map can describe (hd % 8 == 0,
16-byte aligned q, k, v, out and dout) at the padded head dims 32, 64,
112 and 128 (every train path's) take Hopper's wgmma kernels, the rest
(hd 150 and 160, unaligned views) the mma.sync ones: :func:`bwd_route`
names them.
The function carries ``causal`` to the backward, which is the gradient of
the function the forward computed for either value. (The JAX kernel's
``custom_vjp`` backward always applies the causal mask, so its gradient
of ``causal=False`` is wrong: ROADMAP.md C15. The port is held to
``jax.grad`` of ``attention_ref(causal=False)`` instead.)

:func:`flash_attention` launches the kernel for CUDA tensors and takes
:func:`flash_attention_plain` only for CPU tensors. The plain version is
the same tiled online softmax in PyTorch; with ``block_q = block_k`` equal
to the JAX reference's chunk it is ``models/attention.py::_flash_fwd_impl``.
Any sequence length works: the last tile is short, and the causal skip is
derived from token positions, never from tile indices. Without the causal
mask every kv tile runs; only the ragged last tile's positions past S are
left out.
"""

from __future__ import annotations

import collections
import ctypes
import math
import threading
from typing import Tuple

import torch

from ._library import kernel_op, strategies

BLOCK = 64             # the plain version's q and kv tile (rows)
MAX_HEAD_DIM = 160     # the kernels' largest head dim (stablelm-12b's)
BWD_ROWS_TILE = 64     # the backward's scratch rows a tile (rows_at)
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_launcher = None
_bwd_launcher = None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block_q: int = BLOCK, block_k: int = BLOCK,
                          causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (out (B,S,H,hd) in q's dtype, lse (B,S,H)
    f32). Inputs are upcast to f32 (bf16 products are exact in f32, as
    with the reference's ``preferred_element_type``). Causal: kv tiles
    that start after a q tile's last position are skipped. Not causal:
    every kv tile runs, unmasked (the last one is cut at S)."""
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
        for k0 in range(0, q1 if causal else S, block_k):
            k1 = min(k0 + block_k, S)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kf[:, k0:k1]) * scale
            if causal:
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def build() -> None:
    """Build (or load) the CUDA libraries of the forward and the backward
    now rather than at first launch."""
    _load()
    _load_bwd()


ROUTES = ("cuda-cores", "mma.sync", "wgmma")   # flash_attention_route's codes


def _route(q_ptr: int, k_ptr: int, v_ptr: int, hd: int,
           dtype: torch.dtype) -> str:
    from ._build import load
    fn = load("flash_attention").flash_attention_route
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    # out: the wrapper allocates it, so it is aligned; a null pointer is too
    return ROUTES[fn(q_ptr, k_ptr, v_ptr, 0, hd, _DTYPES[dtype])]


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The forward kernel that CUDA inputs q, k, v take, as the C entry
    point picks it by dtype and shape: ``"wgmma"`` (bf16, hd % 8 == 0,
    every base 16-byte aligned: what a TMA tensor map can describe),
    ``"mma.sync"`` (other bf16 inputs) or ``"cuda-cores"`` (f32). Needs
    the card's build."""
    _check(q, k, v)
    return _route(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.shape[3],
                  q.dtype)


def kernel_info(hd: int, dtype: torch.dtype, causal: bool = True) -> dict:
    """Registers, shared memory and blocks an SM of the compiled kernel
    that ``dtype`` and ``causal`` take at head dim ``hd`` for 16-byte
    aligned inputs, and that kernel's ``route`` (``_build.kernel_info``;
    needs the card)."""
    from ._build import kernel_info as info
    row = info("flash_attention", hd, _DTYPES[dtype], int(causal))
    row["route"] = _route(0, 0, 0, hd, dtype)
    return row


def _count(fn, shape: tuple, causal: bool) -> None:
    with _count_lock:
        fn.launches += 1
        fn.shapes[shape] += 1
        if not causal:
            fn.noncausal_launches += 1


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on q's device: the plain version on the CPU, one
    counted kernel launch on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
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
                     _DTYPES[q.dtype], int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    _count(flash_attention, (B, S, H, hd), causal)
    return out, lse


def _fwd_fake(q, k, v, causal):
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, S, H), dtype=torch.float32)


def _fwd_rule(q, k, v, causal):
    """Batch or heads sharded (lse (B, S, H) alike), computed locally."""
    return strategies((q, k, v, causal), 2, batch=((0, 0), (0, 0, 0, None)),
                      heads=((2, 2), (2, 2, 2, None)))


@kernel_op("flash_fwd", _fwd_fake, _fwd_rule)
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return _forward(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, backward kernel: saves (q, k, v, out, lse), as the
    JAX ``custom_vjp`` does, and ``causal``; lse is an output without a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                     causal=ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, H, hd), float32 or bfloat16 → (out (B,S,H,hd) in
    q's dtype, lse (B,S,H) float32); causal, or with ``causal=False``
    every query attends to every key.

    CUDA tensors launch the kernel on the current stream (one launch,
    counted in ``flash_attention.launches``, its (B, S, H, hd) counted in
    ``flash_attention.shapes``, and a launch with ``causal=False`` also in
    ``flash_attention.noncausal_launches``); CPU tensors take the plain
    version; fake tensors compute nothing (``repro_torch::flash_fwd``'s
    fake implementation). Anything else raises. When grad mode is on and
    an input requires grad, the call records an ``autograd.Function``
    whose backward is :func:`flash_attention_bwd` with the same
    ``causal`` (lse gets no gradient)."""
    _check(q, k, v)
    causal = bool(causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash_fwd(q, k, v, causal)


flash_attention.launches = 0
flash_attention.noncausal_launches = 0
flash_attention.shapes = collections.Counter()


# --------------------------------------------------------------------------- #
# Backward
# --------------------------------------------------------------------------- #

def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              block_q: int = BLOCK, block_k: int = BLOCK,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of the backward: ``_flash_bwd_impl`` of the
    JAX package over (q tile, kv tile) pairs at or below the diagonal
    (every pair, unmasked, when not ``causal``), with P recomputed from
    lse, masks from token positions and a short last tile. Sums in f32;
    (dq, dk, dv) in q's dtype."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = dout.float()
    delta = (dof * out.float()).sum(-1)                      # (B,S,H)
    dq = torch.zeros(B, S, H, hd, dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        qi, doi = qf[:, q0:q1], dof[:, q0:q1]
        lsei = lse[:, q0:q1].permute(0, 2, 1)[..., None]     # (B,H,c,1)
        di = delta[:, q0:q1].permute(0, 2, 1)[..., None]
        qpos = torch.arange(q0, q1, device=q.device)
        for k0 in range(0, q1 if causal else S, block_k):
            k1 = min(k0 + block_k, S)
            kj, vj = kf[:, k0:k1], vf[:, k0:k1]
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kj) * scale
            if causal:
                kpos = torch.arange(k0, k1, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                p = torch.where(mask, torch.exp(s - lsei),
                                torch.zeros_like(s))
            else:
                p = torch.exp(s - lsei)
            dp = torch.einsum("bqhd,bkhd->bhqk", doi, vj)
            ds = p * (dp - di) * scale
            dq[:, q0:q1] += torch.einsum("bhqk,bkhd->bqhd", ds, kj)
            dk[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", ds, qi)
            dv[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", p, doi)
    dt = q.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _load_bwd():
    global _bwd_launcher
    if _bwd_launcher is None:
        from ._build import load
        fn = load("flash_attention_bwd").flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_launcher = fn
    return _bwd_launcher


def _bwd_route(ptrs: tuple, hd: int, dtype: torch.dtype) -> str:
    from ._build import load
    fn = load("flash_attention_bwd").flash_attention_bwd_route
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return ROUTES[fn(*ptrs, hd, _DTYPES[dtype])]


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, dout: torch.Tensor) -> str:
    """The backward kernels that CUDA inputs take, as the C entry point
    picks them by dtype and shape: ``"wgmma"`` (bf16, hd % 8 == 0 padding
    to 32, 64, 112 or 128, every base 16-byte aligned), ``"mma.sync"``
    (other bf16 inputs) or ``"cuda-cores"`` (f32). Needs the card's
    build."""
    _check(q, k, v)
    return _bwd_route(tuple(t.data_ptr() for t in (q, k, v, out, dout)),
                      q.shape[3], q.dtype)


def bwd_kernel_info(hd: int, dtype: torch.dtype, which: str,
                    causal: bool = True) -> dict:
    """Registers, shared memory and blocks an SM of the backward's
    ``which`` kernel (``"dkdv"`` or ``"dq"``) that ``dtype`` and
    ``causal`` take at head dim ``hd`` for 16-byte aligned inputs, and
    that kernel's ``route`` (``_build.kernel_info``; needs the card)."""
    from ._build import kernel_info as info
    row = info("flash_attention_bwd", hd, _DTYPES[dtype],
               {"dkdv": 0, "dq": 1}[which], int(causal))
    row["route"] = _bwd_route((0,) * 5, hd, dtype)
    return row


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of flash attention (causal, or full with
    ``causal=False``: the forward's own ``causal``), in q's dtype, from
    the forward's q, k, v, out (B, S, H, hd), lse (B, S, H) float32 and
    the output's gradient dout (B, S, H, hd).

    CUDA tensors launch the backward kernel on the current stream (one
    call, counted in ``flash_attention_bwd.launches`` and its (B, S, H,
    hd) in ``.shapes``, with ``causal=False`` also in
    ``.noncausal_launches``; it runs three CUDA kernels: delta, dk/dv,
    dq); CPU tensors take :func:`flash_attention_bwd_plain`; fake tensors
    compute nothing. Anything else (a meta device too) raises."""
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if (t.shape != q.shape or t.dtype != q.dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd takes {name} of q's "
                             f"shape, dtype and device, contiguous")
    B, S, H, hd = q.shape
    if (lse.shape != (B, S, H) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd takes lse (B, S, H) = "
                         f"{(B, S, H)} float32 on q's device, contiguous")
    return _flash_bwd(q, k, v, out, lse, dout, bool(causal))


def _backward(q, k, v, out, lse, dout, causal):
    """The backward on q's device: the plain version on the CPU, one
    counted call of the backward kernels on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal)
    B, S, H, hd = q.shape
    launch = _load_bwd()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    # scratch: delta (B, S, H), or on the wgmma route delta and lse log2(e)
    # by (b, h) and 64-row tile of S (the C source's rows_at)
    tiles = -(-S // BWD_ROWS_TILE)
    delta = torch.empty(2 * B * H * tiles * BWD_ROWS_TILE,
                        dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     delta.data_ptr(), B, S, H, hd, _DTYPES[q.dtype],
                     int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _count(flash_attention_bwd, (B, S, H, hd), causal)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.noncausal_launches = 0
flash_attention_bwd.shapes = collections.Counter()


def _bwd_fake(q, k, v, out, lse, dout, causal):
    return tuple(torch.empty_like(q) for _ in range(3))


def _bwd_rule(q, k, v, out, lse, dout, causal):
    args = (q, k, v, out, lse, dout, causal)
    return strategies(args, 3, batch=((0,) * 3, (0,) * 6 + (None,)),
                      heads=((2,) * 3, (2,) * 6 + (None,)))


@kernel_op("flash_bwd", _bwd_fake, _bwd_rule)
def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
               causal: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _backward(q, k, v, out, lse, dout, causal)
