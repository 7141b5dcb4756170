"""Mamba-2 SSD chunked scan: CUDA kernel wrapper and plain version.

Per head, a scalar data-dependent decay ``a_t = exp(dt_t · A)`` and the
rank-1 input ``dt_t B_t x_tᵀ`` drive the state
``S_t = a_t S_{t-1} + dt_t B_t x_tᵀ`` with readout ``y_t = C_tᵀ S_t``,
evaluated chunk by chunk: a decay-masked C·Bᵀ score matrix inside a chunk,
the carried (N, P) state between chunks. Replaces the Pallas kernel
``kernels/mamba2_ssd.py::ssd`` of the JAX package (body ``_ssd_kernel``);
the CUDA source, with its bound and design, is ``csrc/mamba2_ssd.cu``. bf16
inputs (the serve path) run the four products on the tensor cores; f32
inputs keep an f32 CUDA-core kernel. One call is one CUDA launch.

:func:`mamba2_ssd` launches the kernel for CUDA tensors and takes
:func:`mamba2_ssd_plain` only for CPU tensors. The plain version is the
JAX package's chunked reference ``models/mamba2.py::ssd_chunked`` in
PyTorch (the port's model imports it under that name).
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Tuple

import torch

from . import refuse_grad

MAX_CHUNK = 64          # the kernel's largest chunk
MAX_DIM = 128           # the kernel's largest state N and head dim P
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_launcher = None


def pick_chunk(T: int, chunk: int = MAX_CHUNK) -> int:
    """The largest c <= ``chunk`` that divides T, as the JAX wrapper picks
    it."""
    c = min(chunk, T)
    while T % c:
        c -= 1
    return c


def mamba2_ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor,
                     state0: torch.Tensor, chunk: int = MAX_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in PyTorch. x: (B, T, H, P); dt: (B, T, H)
    (softplus-ed); A: (H,) negative; Bm, Cm: (B, T, G, N) shared by the
    heads of each group; state0: (B, H, N, P). Returns (y (B,T,H,P) in
    x's dtype, state_T f32)."""
    Bsz, T, H, P = x.shape
    hpg = H // Bm.shape[2]
    c = pick_chunk(T, chunk)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = Bm.float().repeat_interleave(hpg, dim=2)    # (B, T, H, N)
    Ch = Cm.float().repeat_interleave(hpg, dim=2)
    tri = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    state = state0.float()
    ys = []
    for t0 in range(0, T, c):
        xt, dtt = xf[:, t0:t0 + c], dtf[:, t0:t0 + c]
        Bt, Ct = Bh[:, t0:t0 + c], Ch[:, t0:t0 + c]
        cum = torch.cumsum(dtt * Af[None, None], dim=1)        # (B, c, H)
        # inter-chunk: y_t += C_t · (exp(cum_t) S)
        y = torch.einsum("bthn,bhnp->bthp", Ct * torch.exp(cum)[..., None],
                         state)
        # intra-chunk: scores[t, s] = (C_t·B_s) exp(cum_t − cum_s) dt_s,
        # s ≤ t; the difference is clamped at 0 (exact for s ≤ t, no
        # overflow on the masked s > t entries)
        sc = torch.einsum("bthn,bshn->bhts", Ct, Bt)
        decay = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None, :],
                                      max=0.0)).permute(0, 3, 1, 2)
        sc = sc * decay * dtt.permute(0, 2, 1)[:, :, None, :]
        sc = torch.where(tri, sc, torch.zeros_like(sc))
        ys.append(y + torch.einsum("bhts,bshp->bthp", sc, xt))
        # state update: S' = exp(cum_c) S + Σ_s exp(cum_c − cum_s) dt_s B_s x_sᵀ
        last = torch.exp(cum[:, -1])                           # (B, H)
        w_s = torch.exp(cum[:, -1:] - cum) * dtt               # (B, c, H)
        state = state * last[..., None, None] + torch.einsum(
            "bshn,bshp->bhnp", Bt * w_s[..., None], xt)
    return torch.cat(ys, dim=1).to(x.dtype), state


def _check(x, dt, A, Bm, Cm, state0) -> None:
    args = (x, dt, A, Bm, Cm, state0)
    if not all(isinstance(a, torch.Tensor) for a in args):
        raise TypeError("mamba2_ssd takes torch tensors")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"mamba2_ssd takes x (B, T, H, P) and Bm (B, T, G, "
                         f"N), got {tuple(x.shape)} and {tuple(Bm.shape)}")
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    want = {"dt": (B, T, H), "A": (H,), "Bm": (B, T, G, N),
            "Cm": (B, T, G, N), "state0": (B, H, N, P)}
    for name, a in zip(("dt", "A", "Bm", "Cm", "state0"), args[1:]):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(a.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"mamba2_ssd takes x, Bm, Cm of one dtype, float32 "
                        f"or bfloat16, got {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if any(a.dtype != torch.float32 for a in (dt, A, state0)):
        raise TypeError("mamba2_ssd takes dt, A and state0 in float32")
    if not (1 <= P <= MAX_DIM and 1 <= N <= MAX_DIM):
        raise ValueError(f"mamba2_ssd takes P and N in 1..{MAX_DIM}, got "
                         f"P={P}, N={N}")
    if len({a.device for a in args}) != 1:
        raise ValueError("mamba2_ssd inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("mamba2_ssd takes contiguous tensors")


def _load():
    global _launcher
    if _launcher is None:
        from ._build import load
        fn = load("mamba2_ssd").mamba2_ssd_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def build() -> None:
    """Build (or load) the CUDA library now rather than at first launch."""
    _load()


def kernel_info(N: int, P: int, chunk: int, dtype: torch.dtype) -> dict:
    """Registers, shared memory and blocks an SM of the compiled kernel
    that ``dtype`` takes at state N, head dim P and ``chunk``
    (``_build.kernel_info``; needs the card)."""
    from ._build import kernel_info as info
    return info("mamba2_ssd", N, P, chunk, _DTYPES[dtype])


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, state0: torch.Tensor,
               chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P), Bm/Cm (B,T,G,N) float32 or bfloat16; dt (B,T,H), A
    (H,), state0 (B,H,N,P) float32 → (y (B,T,H,P) in x's dtype, state_T
    (B,H,N,P) float32), with the chunk the JAX wrapper picks.

    CUDA tensors launch the kernel on the current stream (one launch,
    counted in ``mamba2_ssd.launches``, its (B, T, H, P, G, N) counted in
    ``mamba2_ssd.shapes``); CPU tensors take the plain version. Anything
    else raises, and so does the CUDA route when grad mode is on and an
    input requires grad (its backward kernel is the next slice,
    ROADMAP.md A12b-2)."""
    _check(x, dt, A, Bm, Cm, state0)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"mamba2_ssd takes chunks 1..{MAX_CHUNK}, got "
                         f"{chunk}")
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, dt, A, Bm, Cm, state0, chunk)
    refuse_grad("mamba2_ssd", x, dt, A, Bm, Cm, state0)
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    launch = _load()
    y = torch.empty_like(x)
    state = torch.empty_like(state0)
    if B == 0 or H == 0:
        return y, state
    if T == 0:
        return y, state.copy_(state0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), state0.data_ptr(),
                     y.data_ptr(), state.data_ptr(), B, T, H, P, G, N,
                     pick_chunk(T, chunk), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        mamba2_ssd.launches += 1
        mamba2_ssd.shapes[(B, T, H, P, G, N)] += 1
    return y, state


mamba2_ssd.launches = 0
mamba2_ssd.shapes = collections.Counter()
