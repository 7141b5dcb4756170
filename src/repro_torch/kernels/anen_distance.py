"""AnEn analog-similarity distance: CUDA kernel wrapper and plain version.

    d2[h, n] = Σ_v (f_hist[h, v, n] − f_now[v, n])²

over H historical forecasts × V forecast variables × N query locations —
the distance behind every fused AnEn member (:mod:`repro_torch.apps.anen`).
Replaces the Pallas kernel ``kernels/anen_distance.py::anen_distance`` of
the JAX package; the CUDA source, with its bound and design, is
``csrc/anen_distance.cu``: one thread per row and four neighbouring
columns, whose loads are all independent (16 bytes each where N % 4 == 0).

:func:`anen_distance` launches the kernel for CUDA tensors and takes
:func:`anen_distance_plain` only for CPU tensors. Both accumulate in the
Pallas body's order with no fused multiply-add, so on the card the kernel
and the plain version agree bit for bit.

:func:`anen_distance_sharded` replaces ``anen_distance_sharded`` of the
JAX package: H split over a 1-D mesh of places (cards, or lanes of one
card), the same kernel launched once per place on its own rows. It needs
no source of its own.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Any, Optional, Sequence

import torch

MAX_VARS = 16          # the kernel unrolls its loop over 16 variables

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
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def build() -> None:
    """Build (or load) the CUDA library now rather than at first launch."""
    _load()


def kernel_info(n: int) -> dict:
    """Registers, shared memory and blocks an SM of the compiled kernel
    that ``n`` columns take with aligned inputs (``_build.kernel_info``;
    needs the card)."""
    from ._build import kernel_info as info
    return info("anen_distance", n)


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
    with torch.cuda.device(f_hist.device):
        stream = torch.cuda.current_stream(f_hist.device).cuda_stream
        err = launch(f_hist.data_ptr(), f_now.data_ptr(), out.data_ptr(),
                     h, v, n, stream)
    if err != 0:
        raise RuntimeError(f"anen_distance kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        anen_distance.launches += 1
        anen_distance.shapes[(h, v, n)] += 1
    return out


anen_distance.launches = 0
anen_distance.shapes = collections.Counter()


def anen_distance_sharded(f_hist: torch.Tensor, f_now: torch.Tensor,
                          devices: Optional[Sequence[Any]] = None
                          ) -> torch.Tensor:
    """:func:`anen_distance` with the H axis split over ``devices``.

    ``devices`` are places — CUDA devices, or lanes of one device
    (:class:`~repro_torch.device.VirtualDevice`) — deduplicated in order;
    below two it is :func:`anen_distance`. ``f_hist`` (H, V, N) is padded
    by edge rows so the places divide it, each place gets its H/D rows and
    its own copy of ``f_now``, and the kernel runs once per place inside
    that place's device and stream context (lanes of one card overlap).
    The results come back to the first place in place order, the padding
    sliced off. Rows are independent, so the answer is
    :func:`anen_distance_plain` over the whole H, bit for bit. Each call
    counts one launch a place in ``anen_distance_sharded.launches`` and its
    per-place (H/D, V, N) in ``.shapes``. CPU tensors on CPU places take
    the plain version per shard; tensors on another kind of device than
    the places raise."""
    from ..device import place_device
    from ..fusion.engine import Mesh

    places = list(dict.fromkeys(devices or []))
    if len(places) < 2:
        return anen_distance(f_hist, f_now)
    _check(f_hist, f_now)
    mesh = Mesh(places)
    kinds = {d.type for d in mesh.devices}
    if kinds != {f_hist.device.type}:
        raise ValueError(f"anen_distance_sharded: tensors on "
                         f"{f_hist.device} but places on "
                         f"{sorted(kinds)}")
    h, v, n = f_hist.shape
    d = mesh.size
    pad = (-h) % d
    fh = f_hist if pad == 0 else torch.cat(
        [f_hist, f_hist[-1:].expand(pad, v, n)])
    per = (h + pad) // d
    outs = []
    mesh.follow_leader()
    for i in range(d):
        rows = mesh.put(fh.narrow(0, i * per, per), i)
        with mesh.on(i):
            now = f_now.to(mesh.devices[i], copy=True)
            outs.append(anen_distance(rows, now))
    leader = place_device(places[0])
    if leader.type == "cuda":
        current = torch.cuda.current_stream(leader)
        for i in range(d):
            stream = mesh.stream(i)
            if stream is not None and stream != current:
                current.wait_stream(stream)
            outs[i].record_stream(current)
    out = torch.cat([o.to(leader) for o in outs])[:h]
    with _count_lock:
        anen_distance_sharded.launches += d
        anen_distance_sharded.shapes[(per, v, n)] += d
    return out


anen_distance_sharded.launches = 0
anen_distance_sharded.shapes = collections.Counter()
