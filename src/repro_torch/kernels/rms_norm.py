"""RMSNorm, with the residual add in front of it: CUDA kernel wrapper and
plain version.

    h = x + delta                                       (rounded once)
    y = (h · rsqrt(mean(h²) + eps)) · scale             (f32 inside)

over the last dim, ``scale`` float32 and ``y`` in x's dtype. Replaces no
Pallas kernel: the JAX package leaves its norms
(``src/repro/models/mlp.py::rms_norm``) to XLA, which fuses the add and
the norm into one pass; eager PyTorch runs :func:`rms_norm_plain` as eight
launches with float32 intermediates, and the add as a ninth. The CUDA source, with its bound and
design, is ``csrc/rms_norm.cu``: one launch, each byte read and written
once, the arithmetic the plain chain's in its order (only the sum of
squares is added in another order: y within one bf16 ulp, h the same
bits).

:func:`fwd_route` picks the route from what the inputs show: ``"fused"``
(the kernel) for a bfloat16 CUDA tensor outside autograd and outside
an activation context over a device mesh (a one-device context, as the
dry-run traces one card, holds plain tensors: the kernel is what that
card runs), whose rows have a contiguous last dim of a multiple of 8 up
to 8192 and a row stride (``h[:, -1:]`` has one), 16-byte aligned, with a
float32 (D,) scale; ``"plain"`` (:func:`rms_norm_plain`, unchanged) for
everything else: CPU tensors, float32, DTensors, a sharded activation
context, training under grad.
Once the route is fused, a refused launch raises; nothing falls back.
:func:`rms_norm` and :func:`add_rms_norm` count each call's route in
``rms_norm.routes`` and each launch in ``rms_norm.launches``, its (rows,
D, with delta) in ``rms_norm.shapes``.

The kernel is a ``torch.library`` op (``repro_torch::rms_norm`` and
``repro_torch::add_rms_norm``), so a step traced on fake CUDA tensors
(the dry-run) passes it as one op with its cost, as the card runs it.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Tuple

import torch

from ._library import kernel_op, strategies

MAX_D = 8192            # the kernel's widest row
VEC = 8                 # bf16 values in the kernel's 16-byte vectors

_count_lock = threading.Lock()
_launcher = None
_fake_type = None


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float
                   ) -> torch.Tensor:
    """Plain PyTorch version: the norm in float32, rounded to x's dtype
    once."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def _load():
    global _launcher
    if _launcher is None:
        from ._build import load
        fn = load("rms_norm").rms_norm_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def build() -> None:
    """Build (or load) the CUDA library now rather than at first launch."""
    _load()


def kernel_info(rows: int, d: int, with_delta: bool) -> dict:
    """Registers, shared memory, spill bytes, blocks an SM and threads of
    the compiled kernel that (rows, d) takes, with or without the residual
    add (``_build.kernel_info``; needs the card)."""
    from ._build import kernel_info as info
    return info("rms_norm", rows, d, int(with_delta))


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The stride between t's rows, seen as (rows, D) with a contiguous
    last dim, or None where its leading dims do not collapse into one."""
    if t.dim() == 0 or t.stride(-1) != 1:
        return None
    stride, span = t.shape[-1], None
    for size, st in zip(reversed(t.shape[:-1]), reversed(t.stride()[:-1])):
        if size == 1:
            continue
        if span is None:
            stride = st
        elif st != span:
            return None
        span = st * size
    return stride


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned base (a fake tensor's storage is taken as
    aligned, as the allocator aligns every block)."""
    global _fake_type
    if _fake_type is None:
        from torch._subclasses.fake_tensor import FakeTensor
        _fake_type = FakeTensor
    if isinstance(t, _fake_type):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


def _is_dtensor(t: torch.Tensor) -> bool:
    if type(t) is torch.Tensor or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def fwd_route(x: torch.Tensor, scale: torch.Tensor,
              delta: Optional[torch.Tensor] = None) -> str:
    """``"fused"`` where the kernel takes these inputs (module docstring),
    else ``"plain"``."""
    from ..models import pspec_ctx
    ins = (x, scale) if delta is None else (x, scale, delta)
    ctx = pspec_ctx.active()
    if (not x.is_cuda or x.dtype != torch.bfloat16
            or any(_is_dtensor(t) for t in ins)
            or (ctx is not None
                and getattr(ctx.mesh, "device_mesh", None) is not None)
            or (torch.is_grad_enabled()
                and any(t.requires_grad for t in ins))):
        return "plain"
    d = x.shape[-1] if x.dim() else 0
    if (not 0 < d <= MAX_D or d % VEC or scale.dtype != torch.float32
            or tuple(scale.shape) != (d,) or scale.device != x.device):
        return "plain"
    if delta is not None and (delta.dtype != x.dtype
                              or delta.shape != x.shape
                              or delta.device != x.device):
        return "plain"
    for t in ins:
        stride = _row_stride(t) if t is not scale else VEC
        if stride is None or stride % VEC or not _aligned(t):
            return "plain"
    return "fused"


def _launch(x, delta, scale, eps):
    """One counted launch: (h or None, y), both contiguous."""
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h = None if delta is None else torch.empty_like(y)
    launch = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), _row_stride(x),
                     None if delta is None else delta.data_ptr(),
                     0 if delta is None else _row_stride(delta),
                     scale.data_ptr(), None if h is None else h.data_ptr(),
                     y.data_ptr(), rows, d, eps, stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        rms_norm.launches += 1
        rms_norm.shapes[(rows, d, delta is not None)] += 1
    return h, y


def _rule(*args):
    """Computed where it lies, replicated (the route takes no DTensor)."""
    return strategies(args, 2 if len(args) == 4 else 1)


def _norm_fake(x, scale, eps):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


@kernel_op("rms_norm", _norm_fake, _rule)
def _norm_op(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    return _launch(x, None, scale, eps)[1]


def _add_norm_fake(x, delta, scale, eps):
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty(x.shape, dtype=x.dtype, device=x.device))


@kernel_op("add_rms_norm", _add_norm_fake, _rule)
def _add_norm_op(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        h = x + delta
        return h, rms_norm_plain(h, scale, eps)
    return _launch(x, delta, scale, eps)


def _count(route: str) -> None:
    with _count_lock:
        rms_norm.routes[route] += 1


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm of x over its last dim: the kernel on :func:`fwd_route`'s
    fused route, else :func:`rms_norm_plain`."""
    route = fwd_route(x, scale)
    _count(route)
    if route == "plain":
        return rms_norm_plain(x, scale, eps)
    return _norm_op(x, scale, eps)


rms_norm.launches = 0
rms_norm.shapes = collections.Counter()
rms_norm.routes = collections.Counter()     # calls by fwd_route's name


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, y) = (x + delta, RMSNorm of h): one kernel launch on
    :func:`fwd_route`'s fused route, else the add and
    :func:`rms_norm_plain`. Counted in :func:`rms_norm`'s counters."""
    route = fwd_route(x, scale, delta)
    _count(route)
    if route == "plain":
        h = x + delta
        return h, rms_norm_plain(h, scale, eps)
    return _add_norm_op(x, delta, scale, eps)
