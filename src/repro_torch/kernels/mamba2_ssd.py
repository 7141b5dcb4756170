"""Mamba-2 SSD chunked scan: CUDA kernel wrapper and plain version.

Per head, a scalar data-dependent decay ``a_t = exp(dt_t · A)`` and the
rank-1 input ``dt_t B_t x_tᵀ`` drive the state
``S_t = a_t S_{t-1} + dt_t B_t x_tᵀ`` with readout ``y_t = C_tᵀ S_t``,
evaluated chunk by chunk: a decay-masked C·Bᵀ score matrix inside a chunk,
the carried (N, P) state between chunks. Replaces the Pallas kernel
``kernels/mamba2_ssd.py::ssd`` of the JAX package (body ``_ssd_kernel``);
the CUDA source, with its bound and design, is ``csrc/mamba2_ssd.cu``. bf16
inputs (the serve path) run the four products on the tensor cores; f32
inputs keep an f32 CUDA-core kernel. One call is one CUDA launch. The shape
and dtype pick the forward's route (:func:`fwd_route`): f32 the CUDA cores;
bf16 at N = P = chunk = 64 with 16-byte aligned tensors Hopper's TMA and
wgmma, one warpgroup a (batch, head) walking the chunks (zamba2's serve and
train paths); other bf16 inputs mma.sync.

:func:`mamba2_ssd` launches the kernel for CUDA tensors and takes
:func:`mamba2_ssd_plain` only for CPU tensors. The plain version is the
JAX package's chunked reference ``models/mamba2.py::ssd_chunked`` in
PyTorch (the port's model imports it under that name).

The backward: the JAX package trains through ``jax.grad`` of
``ssd_chunked`` (it has no backward kernel). :func:`mamba2_ssd_bwd`
computes that gradient with ``csrc/mamba2_ssd_bwd.cu`` for CUDA tensors
and :func:`mamba2_ssd_bwd_plain`, the same equations chunk by chunk in
PyTorch, for CPU tensors. When grad mode is on and an input requires
grad, :func:`mamba2_ssd` records an ``autograd.Function`` whose backward
is :func:`mamba2_ssd_bwd`, on either device. The shape and dtype pick the
backward's route (:func:`bwd_route`): f32 the CUDA cores; bf16 at N = P =
chunk = 64 with one B/C group, at most 8 chunks and 16-byte aligned
tensors (zamba2's train path) Hopper's thread block clusters and wgmma;
other bf16 inputs mma.sync.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._library import kernel_op, strategies
from .costs import pick_chunk  # noqa: F401  (the scans' chunk rule)

MAX_CHUNK = 64          # the kernel's largest chunk
MAX_DIM = 128           # the kernel's largest state N and head dim P
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_launcher = None
_bwd_launcher = None


def upcast(a: torch.Tensor) -> torch.Tensor:
    """``a`` in f32, the plain versions' working type; f64 stays f64, so
    that a test can hold a plain backward to autograd without rounding."""
    return a if a.dtype == torch.float64 else a.float()


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
    xf, dtf, Af = upcast(x), upcast(dt), upcast(A)
    Bh = upcast(Bm).repeat_interleave(hpg, dim=2)    # (B, T, H, N)
    Ch = upcast(Cm).repeat_interleave(hpg, dim=2)
    tri = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    state = upcast(state0)
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
    """Build (or load) the CUDA libraries of the forward and the backward
    now rather than at first launch."""
    _load()
    _load_bwd()


def kernel_info(N: int, P: int, chunk: int, dtype: torch.dtype,
                route: Optional[str] = None) -> dict:
    """Registers, shared memory and blocks an SM of the compiled kernel
    that ``dtype`` takes at state N, head dim P and ``chunk``: f32 the
    CUDA-core kernel, bf16 the mma.sync route's, or with ``route``
    "warpgroup" that route's (N = P = chunk = 64).
    ``_build.kernel_info``; needs the card."""
    from ._build import kernel_info as info
    code = FWD_ROUTES.index(route) if route else _DTYPES[dtype]
    return info("mamba2_ssd", N, P, chunk, code)


# The forward's and the backward's routes, as their launchers' dtype codes
# 0, 1, 2 name them
FWD_ROUTES = ("cuda-cores", "mma.sync", "warpgroup")
BWD_ROUTES = ("cuda-cores", "mma.sync", "cluster")
CLUSTER_DIM = 64          # the Hopper routes' chunk, N and P
CLUSTER_MAX_CHUNKS = 8    # the backward's largest cluster, the portable size


def _hopper_shape(shape, dtype: torch.dtype, ptrs, chunk: int) -> bool:
    """bf16 at N = P = chunk = 64 with every tensor 16-byte aligned (a TMA
    map describes them): the shapes the Hopper routes take."""
    B, T, H, P, G, N = shape
    c = pick_chunk(T, chunk) if T else chunk
    return (dtype == torch.bfloat16 and c == CLUSTER_DIM
            and N == P == CLUSTER_DIM and T >= c
            and all(p % 16 == 0 for p in ptrs))


def _fwd_route(shape, dtype: torch.dtype, ptrs, chunk: int) -> str:
    """The route of :func:`fwd_route`, from the shape (B, T, H, P, G, N),
    the dtype and the data pointers of x, Bm and Cm."""
    if dtype != torch.bfloat16:
        return "cuda-cores"
    return ("warpgroup" if _hopper_shape(shape, dtype, ptrs, chunk)
            else "mma.sync")


def fwd_route(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              chunk: int = MAX_CHUNK) -> str:
    """The route :func:`mamba2_ssd` takes on CUDA tensors, by dtype and
    shape alone: "cuda-cores" for f32 (the first port's scan); for bf16
    at N = P = chunk = 64 with x, Bm, Cm 16-byte aligned (a TMA map
    describes them; y is the wrapper's own) and any number of B/C groups,
    "warpgroup" (one warpgroup a (batch, head) walking the chunks on TMA
    and wgmma, any T: zamba2's serve and train paths); "mma.sync" for
    every other bf16 input (chunk 50, N or P below 64, unaligned views)."""
    return _fwd_route((*x.shape, Bm.shape[2], Bm.shape[3]), x.dtype,
                      [a.data_ptr() for a in (x, Bm, Cm)], chunk)


def _forward(x, dt, A, Bm, Cm, state0, chunk):
    """The forward on x's device: the plain version on the CPU, one
    counted kernel launch on CUDA."""
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, dt, A, Bm, Cm, state0, chunk)
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    launch = _load()
    y = torch.empty_like(x)
    state = torch.empty_like(state0)
    if B == 0 or H == 0:
        return y, state
    if T == 0:
        return y, state.copy_(state0)
    route = fwd_route(x, Bm, Cm, chunk)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), state0.data_ptr(),
                     y.data_ptr(), state.data_ptr(), B, T, H, P, G, N,
                     pick_chunk(T, chunk), FWD_ROUTES.index(route), stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        mamba2_ssd.launches += 1
        mamba2_ssd.shapes[(B, T, H, P, G, N)] += 1
        mamba2_ssd.routes[route] += 1
    return y, state


def _heads_ok(Bm) -> bool:
    """Heads shard only with one B/C group (each head reads its group)."""
    shape = getattr(Bm, "shape", None)
    return shape is not None and shape[2] == 1


def _fwd_fake(x, dt, A, Bm, Cm, state0, chunk):
    return torch.empty_like(x), torch.empty_like(state0)


def _fwd_rule(x, dt, A, Bm, Cm, state0, chunk):
    """Batch sharded, or heads (one B/C group), computed locally."""
    args = (x, dt, A, Bm, Cm, state0, chunk)
    named = {"batch": ((0, 0), (0, 0, None, 0, 0, 0, None))}
    if _heads_ok(Bm):
        named["heads"] = ((2, 1), (2, 2, 0, None, None, 1, None))
    return strategies(args, 2, **named)


@kernel_op("ssd_fwd", _fwd_fake, _fwd_rule)
def _ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, state0: torch.Tensor,
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _forward(x, dt, A, Bm, Cm, state0, chunk)


class _MambaSSD(torch.autograd.Function):
    """Forward kernel, backward kernel: saves the inputs; the backward
    recomputes the chunk states from them. Gradients go to the inputs that
    require one, each in its input's dtype; an output whose gradient is
    not needed (the final state, in a train step) passes ``None``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, state0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, state0)
        ctx.chunk = chunk
        return _ssd_fwd(x, dt, A, Bm, Cm, state0, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, state0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        grads = mamba2_ssd_bwd(x, dt, A, Bm, Cm, state0, dy, dstate,
                               ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, state0: torch.Tensor,
               chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P), Bm/Cm (B,T,G,N) float32 or bfloat16; dt (B,T,H), A
    (H,), state0 (B,H,N,P) float32 → (y (B,T,H,P) in x's dtype, state_T
    (B,H,N,P) float32), with the chunk the JAX wrapper picks.

    CUDA tensors launch the kernel of :func:`fwd_route`'s route on the
    current stream (one launch, counted in ``mamba2_ssd.launches``, its
    (B, T, H, P, G, N) counted in ``mamba2_ssd.shapes`` and its route in
    ``mamba2_ssd.routes``); CPU tensors take the plain version. Anything
    else raises. When grad mode is on and an input requires grad, the call
    records an ``autograd.Function`` whose backward is
    :func:`mamba2_ssd_bwd`."""
    _check(x, dt, A, Bm, Cm, state0)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"mamba2_ssd takes chunks 1..{MAX_CHUNK}, got "
                         f"{chunk}")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, dt, A, Bm, Cm, state0)):
        return _MambaSSD.apply(x, dt, A, Bm, Cm, state0, chunk)
    return _ssd_fwd(x, dt, A, Bm, Cm, state0, chunk)


mamba2_ssd.launches = 0
mamba2_ssd.shapes = collections.Counter()
mamba2_ssd.routes = collections.Counter()   # calls by fwd_route's name


# --------------------------------------------------------------------------- #
# Backward
# --------------------------------------------------------------------------- #

def _chunk_states(xf, dtf, Af, Bh, state0, c):
    """The f32 state at the start of each chunk, by the forward's update."""
    states, state = [], upcast(state0)
    for t0 in range(0, xf.shape[1], c):
        states.append(state)
        dtt = dtf[:, t0:t0 + c]
        cum = torch.cumsum(dtt * Af[None, None], dim=1)
        w_s = torch.exp(cum[:, -1:] - cum) * dtt
        state = state * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bshn,bshp->bhnp", Bh[:, t0:t0 + c] * w_s[..., None],
            xf[:, t0:t0 + c])
    return states


def mamba2_ssd_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor,
                         state0: torch.Tensor, dy: torch.Tensor,
                         dstate_T: Optional[torch.Tensor] = None,
                         chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`mamba2_ssd_plain` in PyTorch, chunk by chunk
    from the last, with the (N, P) state's gradient dS carried back: for a
    chunk with states S (start) and S' (end), a_t = dt_t A, cum its
    inclusive sum, D[t, s] = exp(cum_t − cum_s) for s ≤ t and
    M[t, s] = (C_t·B_s) D[t, s] dt_s (so y_t = e^{cum_t} C_tᵀS + Σ_s M[t, s]
    x_s and S' = e^{cum_L} S + Σ_s e^{cum_L − cum_s} dt_s B_s x_sᵀ):

    - dx_s = Σ_t M[t, s] dy_t + w_s dS'ᵀB_s, with w_s = e^{cum_L − cum_s} dt_s;
    - dB_s = Σ_t dG[t, s] C_t + w_s dS' x_s, dC_t = Σ_s dG[t, s] B_s +
      e^{cum_t} S dy_t, with dG[t, s] = (dy_t·x_s) D[t, s] dt_s;
    - ddt_s = Σ_t (dy_t·x_s)(C_t·B_s) D[t, s] + e^{cum_L − cum_s} B_sᵀdS' x_s
      + A dloga_s, and dA = Σ dt_s dloga_s, where dloga_j sums the
      gradient times the value of every exponent whose cum difference spans
      a_j: Q[t, s] = (dy_t·x_s) M[t, s] for s < j ≤ t (where the clamp of
      cum_t − cum_s at 0 passes it), the readout's e^{cum_t} C_t·S dy_t for
      t ≥ j, w_s B_sᵀdS' x_s for s < j, and e^{cum_L} Σ S ⊙ dS'. (The
      reverse cumsum of per-step totals gives the same sum, but its terms
      cancel: in f32 it misses the JAX tolerance on dA at the train shape.)
    - dS = e^{cum_L} dS' + Σ_t e^{cum_t} C_t dy_tᵀ, carried to the chunk
      before; the first chunk's is dstate0.

    ``dstate_T`` None means zeros. Returns (dx, ddt, dA, dBm, dCm,
    dstate0): dx, dBm and dCm in x's dtype (B and C summed over the heads
    of their group), the rest f32."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    c = pick_chunk(T, chunk)
    xf, dtf, Af, dyf = upcast(x), upcast(dt), upcast(A), upcast(dy)
    Bh = upcast(Bm).repeat_interleave(hpg, dim=2)    # (B, T, H, N)
    Ch = upcast(Cm).repeat_interleave(hpg, dim=2)
    tri = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    strict = tri.tril(-1)
    states = _chunk_states(xf, dtf, Af, Bh, state0, c)
    dS = (torch.zeros_like(upcast(state0)) if dstate_T is None
          else upcast(dstate_T))
    dx, dBh, dCh = (torch.empty_like(a) for a in (xf, Bh, Ch))
    ddt = torch.empty_like(dtf)
    dA = torch.zeros_like(Af)
    for k in reversed(range(len(states))):
        t0, S = k * c, states[k]
        xt, dtt, dyt = xf[:, t0:t0 + c], dtf[:, t0:t0 + c], dyf[:, t0:t0 + c]
        Bt, Ct = Bh[:, t0:t0 + c], Ch[:, t0:t0 + c]
        cum = torch.cumsum(dtt * Af[None, None], dim=1)          # (B, c, H)
        ecum = torch.exp(cum)
        last = ecum[:, -1]                                       # (B, H)
        dec = torch.exp(cum[:, -1:] - cum)                       # (B, c, H)
        w_s = dec * dtt
        # inter-chunk readout y_t += e^{cum_t} C_t·S
        sdy = torch.einsum("bhnp,bthp->bthn", S, dyt)
        dC = ecum[..., None] * sdy
        inter = ecum * (Ct * sdy).sum(-1)                        # (B, c, H)
        # intra-chunk: G = C·Bᵀ, dM = dy·xᵀ, both (B, H, t, s)
        Gm = torch.einsum("bthn,bshn->bhts", Ct, Bt)
        dM = torch.einsum("bthp,bshp->bhts", dyt, xt)
        diff = (cum[:, :, None] - cum[:, None, :]).permute(0, 3, 1, 2)
        D = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)),
                        torch.zeros_like(diff))
        dts = dtt.permute(0, 2, 1)[:, :, None, :]                # (B,H,1,s)
        M = Gm * D * dts
        dG = dM * D * dts
        # d(cum_t − cum_s), where the clamp at 0 passes it
        Q = torch.where(strict & (diff <= 0.0), dM * M, torch.zeros_like(M))
        ddt_c = (dM * Gm * D).sum(2).permute(0, 2, 1)            # (B, s, H)
        dxt = torch.einsum("bhts,bthp->bshp", M, dyt)
        dB = torch.einsum("bhts,bthn->bshn", dG, Ct)
        dC = dC + torch.einsum("bhts,bshn->bthn", dG, Bt)
        # state update: S' = e^{cum_L} S + Σ_s w_s B_s x_sᵀ
        sdx = torch.einsum("bhnp,bshp->bshn", dS, xt)            # dS' x_s
        dB = dB + w_s[..., None] * sdx
        dxt = dxt + w_s[..., None] * torch.einsum("bhnp,bshn->bshp", dS, Bt)
        dW = (Bt * sdx).sum(-1)                                  # (B, c, H)
        ddt_c = ddt_c + dec * dW
        R = dW * w_s
        # cum = cumsum(dt A): a_j reaches every exponent whose difference
        # spans it, so dloga_j sums their gradients times their values (no
        # reverse cumsum of per-step totals, whose terms cancel): Q[t, s]
        # with s < j <= t, the readout's e^{cum_t} for t >= j, w_s's for
        # s < j, and e^{cum_L}'s
        U = F.pad(torch.cumsum(Q, 3)[..., :-1], (1, 0))   # Σ_{s<j} Q[t, s]
        dloga = ((U * tri[None, None, :, :].to(U.dtype)).sum(2)
                 .permute(0, 2, 1)
                 + torch.flip(torch.cumsum(torch.flip(inter, [1]), 1), [1])
                 + F.pad(torch.cumsum(R, 1)[:, :-1], (0, 0, 1, 0))
                 + (last * (S * dS).sum((2, 3)))[:, None])
        ddt[:, t0:t0 + c] = ddt_c + Af[None, None] * dloga
        dA = dA + (dtt * dloga).sum((0, 1))
        dx[:, t0:t0 + c], dBh[:, t0:t0 + c], dCh[:, t0:t0 + c] = dxt, dB, dC
        dS = dS * last[..., None, None] + torch.einsum(
            "bthn,bthp->bhnp", Ct * ecum[..., None], dyt)
    dBm = dBh.reshape(Bsz, T, G, hpg, N).sum(3)
    dCm = dCh.reshape(Bsz, T, G, hpg, N).sum(3)
    return (dx.to(x.dtype), ddt, dA, dBm.to(Bm.dtype), dCm.to(Cm.dtype), dS)


CLUSTER_MAX_HEADS = 16    # the most heads a block of the backward's walks


def _bwd_route(shape, dtype: torch.dtype, ptrs, chunk: int) -> str:
    """The route of :func:`bwd_route`, from the shape (B, T, H, P, G, N),
    the dtype and the data pointers of x, Bm, Cm and dy."""
    B, T, H, P, G, N = shape
    if dtype != torch.bfloat16:
        return "cuda-cores"
    cluster = (_hopper_shape(shape, dtype, ptrs, chunk) and G == 1
               and T // CLUSTER_DIM <= CLUSTER_MAX_CHUNKS)
    return "cluster" if cluster else "mma.sync"


def bwd_route(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              dy: torch.Tensor, chunk: int = MAX_CHUNK) -> str:
    """The route :func:`mamba2_ssd_bwd` takes on CUDA tensors, by dtype and
    shape alone: "cuda-cores" for f32 (the first port's scan); "cluster"
    for bf16 at N = P = chunk = 64 with one B/C group, at most
    ``CLUSTER_MAX_CHUNKS`` chunks and x, Bm, Cm, dy 16-byte aligned (a TMA
    map describes them; zamba2's train path): a thread block cluster over
    the chunks, wgmma; "mma.sync" for every other bf16 input (chunk 50,
    G = 2, N or P below 64, longer T, unaligned views)."""
    return _bwd_route((*x.shape, Bm.shape[2], Bm.shape[3]), x.dtype,
                      [a.data_ptr() for a in (x, Bm, Cm, dy)], chunk)


def cluster_heads(H: int) -> int:
    """Heads a block of the cluster route walks, in order, adding their dB
    and dC on chip: the largest divisor of H up to ``CLUSTER_MAX_HEADS``.
    The fixed-order sums then read H / heads partial sums a row rather
    than H."""
    return max(d for d in range(1, min(H, CLUSTER_MAX_HEADS) + 1)
               if H % d == 0)


def _load_bwd():
    global _bwd_launcher
    if _bwd_launcher is None:
        from ._build import load
        lib = load("mamba2_ssd_bwd")
        fn = lib.mamba2_ssd_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        chunk_fn = lib.mamba2_ssd_bwd_chunk
        chunk_fn.argtypes = [ctypes.c_int] * 5
        chunk_fn.restype = ctypes.c_int
        _bwd_launcher = (fn, chunk_fn)
    return _bwd_launcher


def bwd_kernel_info(N: int, P: int, chunk: int, dtype: torch.dtype,
                    part: str = "chunk") -> dict:
    """Registers, shared memory and blocks an SM of the compiled backward
    kernel for ``dtype`` at state N, head dim P and ``chunk``: f32 its one
    scan kernel; bf16 the ``part`` of a route ("chunk": the mma.sync
    route's chunk kernel, "walk": its walk over the chunk states,
    "cluster": the cluster route's kernel, N = P = chunk = 64).
    ``_build.kernel_info``; needs the card."""
    from ._build import kernel_info as info
    code = 2 if part == "cluster" else _DTYPES[dtype]
    return info("mamba2_ssd_bwd", N, P, chunk, code, int(part == "walk"))


def bwd_max_clusters(n_chunks: int) -> int:
    """How many clusters of the cluster route's kernel (``n_chunks``
    blocks each, at its shared memory) the card holds at once,
    ``cudaOccupancyMaxActiveClusters``; 0 if it cannot place one. Needs
    the card."""
    from ._build import load
    fn = load("mamba2_ssd_bwd").mamba2_ssd_bwd_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(n_chunks, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"mamba2_ssd_bwd_clusters failed: CUDA error "
                           f"{err}")
    return out.value


def mamba2_ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, state0: torch.Tensor,
                   dy: torch.Tensor, dstate_T: Optional[torch.Tensor] = None,
                   chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, ...]:
    """The gradients (dx, ddt, dA, dBm, dCm, dstate0) of
    :func:`mamba2_ssd`'s (y, state_T) against ``dy`` (B,T,H,P, x's dtype)
    and ``dstate_T`` (B,H,N,P float32, or None for zeros), each in its
    input's dtype.

    CUDA tensors launch the backward kernels on the current stream (one
    call, counted in ``mamba2_ssd_bwd.launches``, its (B, T, H, P, G, N)
    in ``.shapes`` and its route in ``.routes``), on the route
    :func:`bwd_route` names. "cluster" runs
    two CUDA kernels: one thread block cluster per (batch, group of
    :func:`cluster_heads` heads), a block per chunk, the chunk states
    passed from block to block through distributed shared memory and
    every product on wgmma; then the fixed-order sums over batches,
    chunks and the head groups' partial dB and dC. "mma.sync" runs three:
    a walk over the chunks writing each chunk's start state and its end
    state's gradient (f32, the updates on the tensor cores), every chunk's
    gradient on the tensor cores, and the fixed-order sums over batches,
    chunks and the heads of a group; f32 runs two: the CUDA-core scan,
    then the sums. CPU tensors take :func:`mamba2_ssd_bwd_plain`. Anything
    else raises."""
    _check(x, dt, A, Bm, Cm, state0)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"mamba2_ssd_bwd takes chunks 1..{MAX_CHUNK}, got "
                         f"{chunk}")
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError("mamba2_ssd_bwd takes dy of x's shape, dtype and "
                         "device, contiguous")
    if dstate_T is not None and (
            dstate_T.shape != state0.shape
            or dstate_T.dtype != torch.float32
            or dstate_T.device != x.device or not dstate_T.is_contiguous()):
        raise ValueError("mamba2_ssd_bwd takes dstate_T of state0's shape, "
                         "float32 on x's device, contiguous, or None")
    return _ssd_bwd(x, dt, A, Bm, Cm, state0, dy, dstate_T, chunk)


def _backward(x, dt, A, Bm, Cm, state0, dy, dstate_T, chunk):
    """The backward on x's device: the plain version on the CPU, one
    counted call of the backward kernels on CUDA."""
    if x.device.type == "cpu":
        return mamba2_ssd_bwd_plain(x, dt, A, Bm, Cm, state0, dy, dstate_T,
                                    chunk)
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    launch, bwd_chunk = _load_bwd()
    dx, dBm, dCm = (torch.empty_like(a) for a in (x, Bm, Cm))
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    dstate0 = torch.empty_like(state0)
    if B == 0 or H == 0 or T == 0:     # nothing to scan: S_T = state0
        if dstate_T is None:
            dstate0.zero_()
        else:
            dstate0.copy_(dstate_T)
        return (dx, ddt, dA.zero_(), dBm, dCm, dstate0)
    route = bwd_route(x, Bm, Cm, dy, chunk)
    code = BWD_ROUTES.index(route)
    with torch.cuda.device(x.device):
        c = bwd_chunk(T, N, P, pick_chunk(T, chunk), code)
        if c < 1:
            raise RuntimeError(f"mamba2_ssd_bwd: no chunk of T={T} fits "
                               f"(N={N}, P={P})")
        K = T // c
        f32 = dict(dtype=torch.float32, device=x.device)
        if route == "cluster":
            # the head groups' partial dB and dC; dA's partials, a (batch,
            # head, chunk) each
            heads = cluster_heads(H)
            work = [None, None, torch.empty(B, T, H // heads, N, **f32),
                    torch.empty(B, T, H // heads, N, **f32),
                    torch.empty(B * H * K, **f32)]
        else:
            # the chunk-start states; on the mma.sync route also the
            # gradients of the chunks' end states; the per-head dB and dC;
            # dA's partials, a (batch, head) each on the f32 route, a
            # (batch, head, chunk) on the mma.sync route
            tc = route == "mma.sync"
            heads = 1
            work = [torch.empty(B * H * K * N * P, **f32),
                    torch.empty(B * H * K * N * P, **f32) if tc else None,
                    torch.empty(B, T, H, N, **f32),
                    torch.empty(B, T, H, N, **f32),
                    torch.empty(B * H * (K if tc else 1), **f32)]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), state0.data_ptr(),
                     dy.data_ptr(),
                     0 if dstate_T is None else dstate_T.data_ptr(),
                     dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                     dBm.data_ptr(), dCm.data_ptr(), dstate0.data_ptr(),
                     *(0 if w is None else w.data_ptr() for w in work),
                     B, T, H, P, G, N, c, code, heads, stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd_bwd kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        mamba2_ssd_bwd.launches += 1
        mamba2_ssd_bwd.shapes[(B, T, H, P, G, N)] += 1
        mamba2_ssd_bwd.routes[route] += 1
    return dx, ddt, dA, dBm, dCm, dstate0


mamba2_ssd_bwd.launches = 0
mamba2_ssd_bwd.shapes = collections.Counter()
mamba2_ssd_bwd.routes = collections.Counter()   # calls by bwd_route's name


def _bwd_fake(x, dt, A, Bm, Cm, state0, dy, dstate_T, chunk):
    return tuple(torch.empty_like(a) for a in (x, dt, A, Bm, Cm, state0))


def _bwd_rule(x, dt, A, Bm, Cm, state0, dy, dstate_T, chunk):
    """Batch sharded (dA summed over it: partial), or heads (one B/C
    group; dB and dC summed over the heads: partial)."""
    args = (x, dt, A, Bm, Cm, state0, dy, dstate_T, chunk)
    named = {"batch": ((0, 0, "P", 0, 0, 0),
                       (0, 0, None, 0, 0, 0, 0, 0, None))}
    if _heads_ok(Bm):
        named["heads"] = ((2, 2, 0, "P", "P", 1),
                          (2, 2, 0, None, None, 1, 2, 1, None))
    return strategies(args, 6, **named)


@kernel_op("ssd_bwd", _bwd_fake, _bwd_rule)
def _ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, state0: torch.Tensor,
             dy: torch.Tensor, dstate_T: Optional[torch.Tensor],
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor, torch.Tensor]:
    return _backward(x, dt, A, Bm, Cm, state0, dy, dstate_T, chunk)
