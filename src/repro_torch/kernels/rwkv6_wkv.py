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
:func:`rwkv6_wkv_plain` only for CPU tensors. The dtype and shape pick the
kernel (:func:`fwd_route`), and nothing else does: bfloat16 runs on the
tensor cores with the state in f32 registers and every f32 operand split
into two bf16 parts, at N = chunk = 64 with 16-byte aligned inputs (the
serve and train paths) on Hopper's TMA and wgmma, one block of three
warpgroups a (batch, head), and otherwise on ``mma.sync``, one block of
four warps a (batch, head); float32
runs the CUDA-core kernel, which meets the f32 tolerance. None falls back
to another. The plain version is the JAX package's chunked reference
``models/rwkv6.py::wkv_chunked`` in PyTorch.

The backward: the JAX package trains through ``jax.grad`` of
``wkv_chunked`` (it has no backward kernel). :func:`rwkv6_wkv_bwd`
computes that gradient with ``csrc/rwkv6_wkv_bwd.cu`` for CUDA tensors and
:func:`rwkv6_wkv_bwd_plain`, the same equations chunk by chunk in PyTorch,
for CPU tensors; :func:`bwd_route` picks its kernels where
:func:`fwd_route` picks the forward's (at N = chunk = 64, aligned, one
block of three warpgroups a (batch, head) on TMA and wgmma: rwkv6-3b's
train path). When grad mode is on and an input requires grad,
:func:`rwkv6_wkv` records an ``autograd.Function`` whose backward is
:func:`rwkv6_wkv_bwd`, on either device.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Tuple

import torch

from ._library import kernel_op, strategies
from .mamba2_ssd import pick_chunk, upcast

MAX_CHUNK = 64          # the kernel's largest chunk
MAX_N = 64              # the kernel's largest head size
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward's and the backward's routes, as their launchers' dtype codes
# 0, 1, 2 name them
FWD_ROUTES = BWD_ROUTES = ("f32", "mma", "wgmma")
WGMMA_DIM = 64          # the wgmma routes' N and chunk

_count_lock = threading.Lock()
_launcher = None
_bwd_launcher = None


def rwkv6_wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
                    chunk: int = MAX_CHUNK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 in PyTorch. r, k, v, w: (B, T, H, N), w the per-step
    decay in (0, 1); u: (H, N); state0: (B, H, N, N) keyed [key channel,
    value channel]. Returns (out (B,T,H,N) in r's dtype, state_T f32)."""
    T = r.shape[1]
    c = pick_chunk(T, chunk)
    rf, kf, vf, wf = (upcast(a) for a in (r, k, v, w))
    uf = upcast(u)
    strict = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    state = upcast(state0)
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
    """Build (or load) the CUDA libraries of the forward and the backward
    now rather than at first launch."""
    _load()
    _load_bwd()


def kernel_info(N: int, chunk: int, dtype: torch.dtype,
                route: Optional[str] = None) -> dict:
    """Registers, shared memory and blocks an SM of the compiled kernel
    that ``dtype`` takes at head size N and ``chunk``: f32 the CUDA-core
    kernel, bf16 the mma.sync route's, or with ``route`` "wgmma" that
    route's (N = chunk = 64). ``_build.kernel_info``; needs the card."""
    from ._build import kernel_info as info
    code = FWD_ROUTES.index(route) if route else _DTYPES[dtype]
    return info("rwkv6_wkv", N, chunk, code)


def _fwd_route(shape, dtype: torch.dtype, ptrs, chunk: int) -> str:
    """The route of :func:`fwd_route`, from the shape (B, T, H, N), the
    dtype and the data pointers of r, k, v and w."""
    if dtype != torch.bfloat16:
        return "f32"
    T, N = shape[1], shape[3]
    c = pick_chunk(T, chunk) if T else chunk
    if (N == c == WGMMA_DIM and T >= c
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "mma"


def fwd_route(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, chunk: int = MAX_CHUNK) -> str:
    """The route :func:`rwkv6_wkv` takes on CUDA tensors, by dtype and
    shape alone: "f32" for float32 (the CUDA-core scan); for bfloat16 at
    N = 64 with the chunk 64 (T a multiple of 64) and r, k, v, w 16-byte
    aligned (a TMA map describes them; out is the wrapper's own), any B and
    H, "wgmma" (per (batch, head) two warpgroups run the elementwise pass a
    chunk ahead of a third that runs the products on TMA tiles and wgmma:
    rwkv6-3b's serve and train paths); "mma" (``mma.sync``) for
    every other bf16 input (N below 64, a chunk below 64, unaligned
    views)."""
    return _fwd_route(tuple(r.shape), r.dtype,
                      [a.data_ptr() for a in (r, k, v, w)], chunk)


def _forward(r, k, v, w, u, state0, chunk):
    """The forward on r's device: the plain version on the CPU, one
    counted kernel launch on CUDA."""
    if r.device.type == "cpu":
        return rwkv6_wkv_plain(r, k, v, w, u, state0, chunk)
    B, T, H, N = r.shape
    launch = _load()
    out = torch.empty_like(r)
    state = torch.empty_like(state0)
    if B == 0 or H == 0:
        return out, state
    if T == 0:
        return out, state.copy_(state0)
    route = fwd_route(r, k, v, w, chunk)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), state0.data_ptr(), out.data_ptr(),
                     state.data_ptr(), B, T, H, N, pick_chunk(T, chunk),
                     FWD_ROUTES.index(route), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        rwkv6_wkv.launches += 1
        rwkv6_wkv.shapes[(B, T, H, N)] += 1
        rwkv6_wkv.routes[route] += 1
    return out, state


def _fwd_fake(r, k, v, w, u, state0, chunk):
    return torch.empty_like(r), torch.empty_like(state0)


def _fwd_rule(r, k, v, w, u, state0, chunk):
    """Batch or heads sharded, computed locally."""
    return strategies((r, k, v, w, u, state0, chunk), 2,
                      batch=((0, 0), (0, 0, 0, 0, None, 0, None)),
                      heads=((2, 1), (2, 2, 2, 2, 0, 1, None)))


@kernel_op("wkv_fwd", _fwd_fake, _fwd_rule)
def _wkv_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _forward(r, k, v, w, u, state0, chunk)


class _RwkvWKV(torch.autograd.Function):
    """Forward kernel, backward kernel: saves the inputs; the backward
    recomputes the chunk states from them. Gradients go to the inputs that
    require one, each in its input's dtype; an output whose gradient is
    not needed (the final state, in a train step) passes ``None``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state0)
        ctx.chunk = chunk
        return _wkv_fwd(r, k, v, w, u, state0, chunk)

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, state0 = ctx.saved_tensors
        dout = torch.zeros_like(r) if dout is None else dout.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        grads = rwkv6_wkv_bwd(r, k, v, w, u, state0, dout, dstate, ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
              chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,T,H,N) float32 or bfloat16; u (H,N), state0
    (B,H,N,N) float32 → (out (B,T,H,N) in r's dtype, state_T (B,H,N,N)
    float32), with the chunk the JAX wrapper picks.

    CUDA tensors launch the kernel of :func:`fwd_route`'s route on the
    current stream (one launch, counted in ``rwkv6_wkv.launches``, its
    (B, T, H, N) counted in ``rwkv6_wkv.shapes`` and its route in
    ``rwkv6_wkv.routes``); CPU tensors take the plain version. Anything
    else raises. When grad mode is on and an input requires grad, the call
    records an ``autograd.Function`` whose backward is
    :func:`rwkv6_wkv_bwd`."""
    _check(r, k, v, w, u, state0)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_wkv takes chunks 1..{MAX_CHUNK}, got "
                         f"{chunk}")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (r, k, v, w, u, state0)):
        return _RwkvWKV.apply(r, k, v, w, u, state0, chunk)
    return _wkv_fwd(r, k, v, w, u, state0, chunk)


rwkv6_wkv.launches = 0
rwkv6_wkv.shapes = collections.Counter()
rwkv6_wkv.routes = collections.Counter()    # calls by fwd_route's name


# --------------------------------------------------------------------------- #
# Backward
# --------------------------------------------------------------------------- #

def _logw_cum(wt: torch.Tensor):
    """(w clamped at 1e-8, log w, raw cumsum, cum clamped at -30) of a
    chunk, as the forward takes them."""
    wc = torch.clamp(wt, min=1e-8)
    logw = torch.log(wc)
    raw = torch.cumsum(logw, dim=1)
    return wc, logw, raw, torch.clamp(raw, min=-30.0)


def _chunk_states(kf, vf, wf, state0, c):
    """The f32 state at the start of each chunk, by the forward's update."""
    states, state = [], upcast(state0)
    for t0 in range(0, kf.shape[1], c):
        states.append(state)
        cum = _logw_cum(wf[:, t0:t0 + c])[3]
        k_scaled = kf[:, t0:t0 + c] * torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bshn,bshm->bhnm", k_scaled, vf[:, t0:t0 + c])
    return states


def rwkv6_wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        state0: torch.Tensor, dout: torch.Tensor,
                        dstate_T: Optional[torch.Tensor] = None,
                        chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`rwkv6_wkv_plain` in PyTorch, chunk by chunk
    from the last, with the (N, N) state's gradient dS carried back. With
    the forward's r_dec = r e^{cum − logw}, k_over = k e^{−cum}, k_scaled =
    k e^{cum_L − cum}, the strictly lower scores and the bonus diag_t =
    Σ_n r u k, for a chunk with start state S and end gradient dS':

    - dr_dec_t = S dout_t + Σ_{s<t} (dout_t·v_s) k_over_s, dk_over_s =
      Σ_{t>s} (dout_t·v_s) r_dec_t, dk_scaled_s = dS' v_s;
    - dv_s = Σ_{t>s} scores[t, s] dout_t + diag_s dout_s + dS'ᵀ k_scaled_s;
    - dr, dk: those through their factors, plus the bonus's (dout_t·v_t) u
      k_t and (dout_t·v_t) u r_t; du = Σ (dout_t·v_t) r_t k_t;
    - each exponent's gradient times its value goes to the cum and logw it
      reads (e^{cum_L} Σ_m S ⊙ dS' too); no gradient passes where the
      cumsum is clamped at −30; the reverse cumsum takes it to logw, and
      dw = dlogw / w where w ≥ 1e-8 (0 below the clamp);
    - dS = e^{cum_L} dS' + Σ_t r_dec_tᵀ dout_t, carried to the chunk before;
      the first chunk's is dstate0.

    ``dstate_T`` None means zeros. Returns (dr, dk, dv, dw, du, dstate0):
    the first four in r's dtype, du and dstate0 f32."""
    T = r.shape[1]
    c = pick_chunk(T, chunk)
    rf, kf, vf, wf, dof = (upcast(a) for a in (r, k, v, w, dout))
    uf = upcast(u)
    strict = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    states = _chunk_states(kf, vf, wf, state0, c)
    dS = (torch.zeros_like(upcast(state0)) if dstate_T is None
          else upcast(dstate_T))
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for j in reversed(range(len(states))):
        t0, S = j * c, states[j]
        rt, kt, vt, wt, dot = (a[:, t0:t0 + c] for a in (rf, kf, vf, wf, dof))
        wc, logw, raw, cum = _logw_cum(wt)
        p_prev = torch.exp(cum - logw)
        r_dec = rt * p_prev
        e_neg = torch.exp(-cum)
        k_over = kt * e_neg
        p_last = torch.exp(cum[:, -1])                          # (B, H, N)
        decay = torch.exp(cum[:, -1:] - cum)
        k_scaled = kt * decay
        scores = torch.einsum("bthn,bshn->bhts", r_dec, k_over)
        scores = torch.where(strict, scores, torch.zeros_like(scores))
        dscores = torch.einsum("bthm,bshm->bhts", dot, vt)
        dscores = torch.where(strict, dscores, torch.zeros_like(dscores))
        diag = (rt * uf[None, None] * kt).sum(-1)               # (B, c, H)
        ddiag = (dot * vt).sum(-1)
        dr_dec = (torch.einsum("bhnm,bthm->bthn", S, dot)
                  + torch.einsum("bhts,bshn->bthn", dscores, k_over))
        dk_over = torch.einsum("bhts,bthn->bshn", dscores, r_dec)
        dk_scaled = torch.einsum("bhnm,bshm->bshn", dS, vt)
        dv[:, t0:t0 + c] = (torch.einsum("bhts,bthm->bshm", scores, dot)
                            + diag[..., None] * dot
                            + torch.einsum("bshn,bhnm->bshm", k_scaled, dS))
        bonus = ddiag[..., None] * uf[None, None]
        dr[:, t0:t0 + c] = dr_dec * p_prev + bonus * kt
        dk[:, t0:t0 + c] = dk_over * e_neg + dk_scaled * decay + bonus * rt
        du = du + torch.einsum("bth,bthn->hn", ddiag, rt * kt)
        # exponents: r_dec reads cum − logw, k_over −cum, k_scaled and
        # p_last cum_L − cum and cum_L
        ek = dk_scaled * k_scaled
        dcum = dr_dec * r_dec - dk_over * k_over - ek
        dcum[:, -1] += ek.sum(1) + p_last * (S * dS).sum(-1)
        draw = torch.where(raw >= -30.0, dcum, torch.zeros_like(dcum))
        dlogw = (torch.flip(torch.cumsum(torch.flip(draw, [1]), 1), [1])
                 - dr_dec * r_dec)
        dw[:, t0:t0 + c] = torch.where(wt >= 1e-8, dlogw / wc,
                                       torch.zeros_like(dlogw))
        dS = dS * p_last[..., None] + torch.einsum(
            "bthn,bthm->bhnm", r_dec, dot)
    dt = r.dtype
    return dr.to(dt), dk.to(dt), dv.to(dt), dw.to(dt), du, dS


def _load_bwd():
    global _bwd_launcher
    if _bwd_launcher is None:
        from ._build import load
        fn = load("rwkv6_wkv_bwd").rwkv6_wkv_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_launcher = fn
    return _bwd_launcher


def bwd_kernel_info(N: int, chunk: int, dtype: torch.dtype,
                    part: str = "chunk") -> dict:
    """Registers, shared memory and blocks an SM of the compiled backward
    kernel for ``dtype`` at head size N and ``chunk``: f32 its one scan
    kernel; bf16 the ``part`` of a route ("chunk": the mma route's chunk
    kernel, "walk": its walk over the chunk states, "wgmma": the wgmma
    route's kernel, N = chunk = 64). ``_build.kernel_info``; needs the
    card."""
    from ._build import kernel_info as info
    code = BWD_ROUTES.index("wgmma") if part == "wgmma" else _DTYPES[dtype]
    return info("rwkv6_wkv_bwd", N, chunk, code, int(part == "walk"))


def bwd_route(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, dout: torch.Tensor,
              chunk: int = MAX_CHUNK) -> str:
    """The route :func:`rwkv6_wkv_bwd` takes on CUDA tensors, by dtype and
    shape alone, where the forward takes its wgmma route: "f32" for
    float32 (the CUDA-core scan); for bfloat16 at N = 64 with the chunk 64
    (T a multiple of 64) and r, k, v, w, dout 16-byte aligned (TMA maps
    describe them), any B and H, "wgmma" (one block of three warpgroups a
    (batch, head): the chunk states by a walk forwards, then the gradient
    by a walk backwards with the state's gradient in registers, every
    product on wgmma: rwkv6-3b's train path); "mma" (the ``mma.sync``
    walk and chunk kernels) for every other bf16 input."""
    return _fwd_route(tuple(r.shape), r.dtype,
                      [a.data_ptr() for a in (r, k, v, w, dout)], chunk)


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
                  dout: torch.Tensor, dstate_T: Optional[torch.Tensor] = None,
                  chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, ...]:
    """The gradients (dr, dk, dv, dw, du, dstate0) of :func:`rwkv6_wkv`'s
    (out, state_T) against ``dout`` (B,T,H,N, r's dtype) and ``dstate_T``
    (B,H,N,N float32, or None for zeros), each in its input's dtype.

    CUDA tensors launch the backward kernels on the current stream (one
    call, counted in ``rwkv6_wkv_bwd.launches``, its (B, T, H, N) in
    ``.shapes`` and its route in ``.routes``), on the route
    :func:`bwd_route` names. "wgmma" runs two CUDA kernels: one block of
    three warpgroups a (batch, head) that walks the chunks forwards,
    writing each chunk's start state to a workspace as bf16 hi + lo tiles,
    then backwards with the state's gradient in f32 registers, every
    product on wgmma (every f32 operand split into bf16 hi + lo, three
    parts in dscores·k_over and dscoresᵀ·r_dec), and du's fixed-order sum
    over batches. "mma" runs three: a walk over the chunks
    writing each chunk's start state and its end state's gradient (f32,
    the updates on the tensor cores), every chunk's gradient on the tensor
    cores (``mma.sync``, every f32 operand split into bf16 hi + lo), and
    du's fixed-order sum over batches and chunks; f32 runs two: the
    CUDA-core scan, then du's sum.
    CPU tensors take :func:`rwkv6_wkv_bwd_plain`. Anything else raises."""
    _check(r, k, v, w, u, state0)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_wkv_bwd takes chunks 1..{MAX_CHUNK}, got "
                         f"{chunk}")
    if (dout.shape != r.shape or dout.dtype != r.dtype
            or dout.device != r.device or not dout.is_contiguous()):
        raise ValueError("rwkv6_wkv_bwd takes dout of r's shape, dtype and "
                         "device, contiguous")
    if dstate_T is not None and (
            dstate_T.shape != state0.shape
            or dstate_T.dtype != torch.float32
            or dstate_T.device != r.device or not dstate_T.is_contiguous()):
        raise ValueError("rwkv6_wkv_bwd takes dstate_T of state0's shape, "
                         "float32 on r's device, contiguous, or None")
    return _wkv_bwd(r, k, v, w, u, state0, dout, dstate_T, chunk)


def _backward(r, k, v, w, u, state0, dout, dstate_T, chunk):
    """The backward on r's device: the plain version on the CPU, one
    counted call of the backward kernels on CUDA."""
    if r.device.type == "cpu":
        return rwkv6_wkv_bwd_plain(r, k, v, w, u, state0, dout, dstate_T,
                                   chunk)
    B, T, H, N = r.shape
    launch = _load_bwd()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du, dstate0 = torch.empty_like(u), torch.empty_like(state0)
    if B == 0 or H == 0 or T == 0:     # nothing to scan: S_T = state0
        if dstate_T is None:
            dstate0.zero_()
        else:
            dstate0.copy_(dstate_T)
        return dr, dk, dv, dw, du.zero_(), dstate0
    c = pick_chunk(T, chunk)
    K = T // c
    route = bwd_route(r, k, v, w, dout, chunk)
    tc = route == "mma"
    with torch.cuda.device(r.device):
        f32 = dict(dtype=torch.float32, device=r.device)
        # the chunk-start states (f32, or on the wgmma route their bf16 hi
        # and lo tiles: the same bytes as N x N / 2 floats twice); on the
        # mma route also the gradients of the chunks' end states; du's
        # partials, a (batch, head, chunk) each on the mma route, a (batch,
        # head) on the others
        work = [torch.empty(B * H * K * N * N, **f32),
                torch.empty(B * H * K * N * N, **f32) if tc else None,
                torch.empty(B * H * (K if tc else 1) * N, **f32)]
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), state0.data_ptr(), dout.data_ptr(),
                     0 if dstate_T is None else dstate_T.data_ptr(),
                     dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     dw.data_ptr(), du.data_ptr(), dstate0.data_ptr(),
                     *(0 if a is None else a.data_ptr() for a in work),
                     B, T, H, N, c, BWD_ROUTES.index(route), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv_bwd kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        rwkv6_wkv_bwd.launches += 1
        rwkv6_wkv_bwd.shapes[(B, T, H, N)] += 1
        rwkv6_wkv_bwd.routes[route] += 1
    return dr, dk, dv, dw, du, dstate0


rwkv6_wkv_bwd.launches = 0
rwkv6_wkv_bwd.shapes = collections.Counter()
rwkv6_wkv_bwd.routes = collections.Counter()   # calls by bwd_route's name


def _bwd_fake(r, k, v, w, u, state0, dout, dstate_T, chunk):
    return tuple(torch.empty_like(a) for a in (r, k, v, w, u, state0))


def _bwd_rule(r, k, v, w, u, state0, dout, dstate_T, chunk):
    """Batch sharded (du summed over it: partial) or heads sharded."""
    return strategies((r, k, v, w, u, state0, dout, dstate_T, chunk), 6,
                      batch=((0, 0, 0, 0, "P", 0),
                             (0, 0, 0, 0, None, 0, 0, 0, None)),
                      heads=((2, 2, 2, 2, 0, 1),
                             (2, 2, 2, 2, 0, 1, 2, 1, None)))


@kernel_op("wkv_bwd", _bwd_fake, _bwd_rule)
def _wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
             dout: torch.Tensor, dstate_T: Optional[torch.Tensor],
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor, torch.Tensor]:
    return _backward(r, k, v, w, u, state0, dout, dstate_T, chunk)
