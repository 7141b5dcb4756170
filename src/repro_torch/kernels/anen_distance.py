"""AnEn analog-similarity distance: CUDA kernel wrapper and plain version.

    d2[h, n] = Σ_v (f_hist[h, v, n] − f_now[v, n])²

over H historical forecasts × V forecast variables × N query locations —
the distance behind every fused AnEn member (:mod:`repro_torch.apps.anen`).
Replaces the Pallas kernel ``kernels/anen_distance.py::anen_distance`` of
the JAX package; the CUDA source, with its bound and design, is
``csrc/anen_distance.cu``.

:func:`anen_distance` launches the kernel for CUDA tensors and takes
:func:`anen_distance_plain` only for CPU tensors. Both accumulate in the
Pallas body's order with no fused multiply-add, so on the card the kernel
and the plain version agree bit for bit.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import torch

MAX_VARS = 16          # the kernel keeps f_now[:, n] in 16 registers
ROWS_PER_BLOCK = 8     # h rows each thread walks
_MAX_GRID_Y = 65535

_count_lock = threading.Lock()
_launcher = None


def anen_distance_plain(f_hist: torch.Tensor, f_now: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version: the same explicit loop over ``v`` as the
    kernel (eager ops never contract ``d*d + acc`` into an FMA)."""
    acc = torch.zeros(f_hist.shape[0], f_hist.shape[2], dtype=torch.float32,
                      device=f_hist.device)
    for v in range(f_hist.shape[1]):
        d = f_hist[:, v, :] - f_now[v, :][None, :]
        acc = acc + d * d
    return acc


def _check(f_hist: torch.Tensor, f_now: torch.Tensor) -> None:
    if not (isinstance(f_hist, torch.Tensor) and isinstance(f_now, torch.Tensor)):
        raise TypeError("anen_distance takes torch tensors")
    if f_hist.dtype != torch.float32 or f_now.dtype != torch.float32:
        raise TypeError(f"anen_distance takes float32, got {f_hist.dtype} "
                        f"and {f_now.dtype}")
    if f_hist.dim() != 3 or f_now.dim() != 2:
        raise ValueError(f"anen_distance takes (H, V, N) and (V, N), got "
                         f"{tuple(f_hist.shape)} and {tuple(f_now.shape)}")
    _, v, n = f_hist.shape
    if tuple(f_now.shape) != (v, n):
        raise ValueError(f"f_now must be {(v, n)}, got {tuple(f_now.shape)}")
    if not 1 <= v <= MAX_VARS:
        raise ValueError(f"anen_distance takes 1..{MAX_VARS} variables, "
                         f"got {v}")
    if f_hist.device != f_now.device:
        raise ValueError(f"inputs on different devices: {f_hist.device} "
                         f"and {f_now.device}")
    if f_hist.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {f_hist.device}")
    if not (f_hist.is_contiguous() and f_now.is_contiguous()):
        raise ValueError("anen_distance takes contiguous tensors")


def _load():
    global _launcher
    if _launcher is None:
        from ._build import load
        fn = load("anen_distance").anen_distance_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def build() -> None:
    """Build (or load) the CUDA library now rather than at first launch."""
    _load()


def anen_distance(f_hist: torch.Tensor, f_now: torch.Tensor) -> torch.Tensor:
    """``f_hist`` (H, V, N), ``f_now`` (V, N) float32 → (H, N) float32.

    CUDA tensors launch the kernel on the current stream (one launch,
    counted in ``anen_distance.launches``, its (H, V, N) counted in
    ``anen_distance.shapes``); CPU tensors take the plain version.
    Anything else raises."""
    _check(f_hist, f_now)
    if f_hist.device.type == "cpu":
        return anen_distance_plain(f_hist, f_now)
    h, v, n = f_hist.shape
    launch = _load()
    out = torch.empty(h, n, dtype=torch.float32, device=f_hist.device)
    if h == 0 or n == 0:
        return out
    rows = max(ROWS_PER_BLOCK, -(-h // _MAX_GRID_Y))
    with torch.cuda.device(f_hist.device):
        stream = torch.cuda.current_stream(f_hist.device).cuda_stream
        err = launch(f_hist.data_ptr(), f_now.data_ptr(), out.data_ptr(),
                     h, v, n, rows, stream)
    if err != 0:
        raise RuntimeError(f"anen_distance kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        anen_distance.launches += 1
        anen_distance.shapes[(h, v, n)] += 1
    return out


anen_distance.launches = 0
anen_distance.shapes = collections.Counter()
