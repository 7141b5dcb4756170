"""RWKV-6 WKV chunked recurrence: CUDA kernel wrapper and plain version.

Per head, a per-channel data-dependent decay ``w_t`` and the rank-1 input
``k_t v_tᵀ`` drive the (N, N) state ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ``
with readout ``out_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)``, evaluated
chunk by chunk: a decay-weighted strictly lower score matrix inside a
chunk, the ``u`` bonus on its diagonal, the carried state between chunks,
with log-space decays clamped at −30. Replaces the Pallas kernel
``kernels/rwkv6_wkv.py::wkv`` of the JAX package (body ``_wkv_kernel``);
the CUDA source, with its bound and design, is ``csrc/rwkv6_wkv.cu``.

:func:`rwkv6_wkv` launches a kernel for CUDA tensors and takes
:func:`rwkv6_wkv_plain` only for CPU tensors. The input dtype picks the
kernel, and nothing else does: bfloat16 (the serve path) runs on the
tensor cores, one block per (batch, head) with the state in registers and
every f32 operand split into two bf16 parts; float32 runs the CUDA-core
kernel, which meets the f32 tolerance. Neither falls back to the other.
The plain version is the JAX package's chunked reference
``models/rwkv6.py::wkv_chunked`` in PyTorch.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Tuple

import torch

from . import refuse_grad
from .mamba2_ssd import pick_chunk

MAX_CHUNK = 64          # the kernel's largest chunk
MAX_N = 64              # the kernel's largest head size
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_launcher = None


def rwkv6_wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
                    chunk: int = MAX_CHUNK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 in PyTorch. r, k, v, w: (B, T, H, N), w the per-step
    decay in (0, 1); u: (H, N); state0: (B, H, N, N) keyed [key channel,
    value channel]. Returns (out (B,T,H,N) in r's dtype, state_T f32)."""
    T = r.shape[1]
    c = pick_chunk(T, chunk)
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    strict = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    state = state0.float()
    outs = []
    for t0 in range(0, T, c):
        rt, kt, vt, wt = (a[:, t0:t0 + c] for a in (rf, kf, vf, wf))
        logw = torch.log(torch.clamp(wt, min=1e-8))
        # P_t = exp(cum_t); the clamp bounds exp(-cum) at e30 in f32
        cum = torch.clamp(torch.cumsum(logw, dim=1), min=-30.0)
        # inter-chunk: out_t += (r_t ⊙ P_{t-1}) @ state
        r_dec = rt * torch.exp(cum - logw)
        out = torch.einsum("bthn,bhnm->bthm", r_dec, state)
        # intra-chunk: strictly lower scores, the bonus u on the diagonal
        k_over = kt * torch.exp(-cum)
        scores = torch.einsum("bthn,bshn->bhts", r_dec, k_over)
        scores = torch.where(strict, scores, torch.zeros_like(scores))
        diag = torch.einsum("bthn,bthn->bth", rt * uf[None, None], kt)
        out = out + torch.einsum("bhts,bshm->bthm", scores, vt)
        outs.append(out + diag[..., None] * vt)
        # state update: S' = diag(P_c) S + Σ_s (P_c/P_s) k_s v_sᵀ
        p_last = torch.exp(cum[:, -1])
        k_scaled = kt * torch.exp(cum[:, -1:] - cum)
        state = state * p_last[..., None] + torch.einsum(
            "bshn,bshm->bhnm", k_scaled, vt)
    return torch.cat(outs, dim=1).to(r.dtype), state


def _check(r, k, v, w, u, state0) -> None:
    args = (r, k, v, w, u, state0)
    if not all(isinstance(a, torch.Tensor) for a in args):
        raise TypeError("rwkv6_wkv takes torch tensors")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_wkv takes r (B, T, H, N), got "
                         f"{tuple(r.shape)}")
    B, T, H, N = r.shape
    want = {"k": (B, T, H, N), "v": (B, T, H, N), "w": (B, T, H, N),
            "u": (H, N), "state0": (B, H, N, N)}
    for name, a in zip(("k", "v", "w", "u", "state0"), args[1:]):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(a.shape)}")
    if r.dtype not in _DTYPES or any(a.dtype != r.dtype for a in (k, v, w)):
        raise TypeError(f"rwkv6_wkv takes r, k, v, w of one dtype, float32 "
                        f"or bfloat16, got "
                        f"{[str(a.dtype) for a in (r, k, v, w)]}")
    if u.dtype != torch.float32 or state0.dtype != torch.float32:
        raise TypeError("rwkv6_wkv takes u and state0 in float32")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"rwkv6_wkv takes N in 1..{MAX_N}, got {N}")
    if len({a.device for a in args}) != 1:
        raise ValueError("rwkv6_wkv inputs on different devices")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {r.device}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("rwkv6_wkv takes contiguous tensors")


def _load():
    global _launcher
    if _launcher is None:
        from ._build import load
        fn = load("rwkv6_wkv").rwkv6_wkv_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def build() -> None:
    """Build (or load) the CUDA library now rather than at first launch."""
    _load()


def kernel_info(N: int, chunk: int, dtype: torch.dtype) -> dict:
    """Registers, shared memory and blocks an SM of the compiled kernel
    that ``dtype`` takes at head size N and ``chunk`` (``_build.kernel_info``;
    needs the card)."""
    from ._build import kernel_info as info
    return info("rwkv6_wkv", N, chunk, _DTYPES[dtype])


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
              chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,T,H,N) float32 or bfloat16; u (H,N), state0
    (B,H,N,N) float32 → (out (B,T,H,N) in r's dtype, state_T (B,H,N,N)
    float32), with the chunk the JAX wrapper picks.

    CUDA tensors launch the kernel of their dtype on the current stream
    (bfloat16: tensor cores; float32: CUDA cores; one launch,
    counted in ``rwkv6_wkv.launches``, its (B, T, H, N) counted in
    ``rwkv6_wkv.shapes``); CPU tensors take the plain version. Anything
    else raises, and so does the CUDA route when grad mode is on and an
    input requires grad (its backward kernel is the next slice,
    ROADMAP.md A12b-2)."""
    _check(r, k, v, w, u, state0)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_wkv takes chunks 1..{MAX_CHUNK}, got "
                         f"{chunk}")
    if r.device.type == "cpu":
        return rwkv6_wkv_plain(r, k, v, w, u, state0, chunk)
    refuse_grad("rwkv6_wkv", r, k, v, w, u, state0)
    B, T, H, N = r.shape
    launch = _load()
    out = torch.empty_like(r)
    state = torch.empty_like(state0)
    if B == 0 or H == 0:
        return out, state
    if T == 0:
        return out, state.copy_(state0)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), state0.data_ptr(), out.data_ptr(),
                     state.data_ptr(), B, T, H, N, pick_chunk(T, chunk),
                     _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        rwkv6_wkv.launches += 1
        rwkv6_wkv.shapes[(B, T, H, N)] += 1
    return out, state


rwkv6_wkv.launches = 0
rwkv6_wkv.shapes = collections.Counter()
