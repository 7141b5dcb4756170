"""The kernels' work: bytes moved, operations done and f32 workspace held
a call, from the shapes alone.

One definition serves two readers. ``chip_smoke.py`` turns the bytes and
operations into each kernel's bound (the least time the card could take:
the larger of the bytes over the memory rate and the operations over the
peak rate of their type). :mod:`repro_torch.launch.op_analysis` counts them
for every kernel call of a traced step, where the call computes nothing
(fake and meta tensors), and the memory tracker adds the workspace the
CUDA wrapper allocates for the call's duration.

The rates are the published peaks of one NVIDIA H100 SXM5 80GB (the NVIDIA
data sheet, at its 700 W limit): spec-sheet figures, not measurements.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

# published peaks of one H100 SXM5 80GB (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12      # dense, tensor cores

MAX_CHUNK = 64                 # the scans' largest chunk


def pick_chunk(T: int, chunk: int = MAX_CHUNK) -> int:
    """The largest c <= ``chunk`` that divides T, as the JAX wrapper picks
    it."""
    c = min(chunk, T)
    while T % c:
        c -= 1
    return c


def _bound(bytes_: int, flops: float, rate: float) -> dict:
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bytes": bytes_, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_cuda_core_ops_ms": flops / FP32_FLOPS_PER_S * 1e3}


def distance_bound(shape) -> dict:
    """Least time for (H, V, N): each input read once and the output
    written once, in f32, against 3·H·V·N f32 operations."""
    h, v, n = shape
    bytes_ = 4 * (h * v * n + v * n + h * n)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * h * v * n / FP32_FLOPS_PER_S * 1e3
    return {"bytes": bytes_, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_pairs(S: int, causal: bool = True) -> float:
    """The (q, k) pairs one (b, h) of attention computes: S(S+1)/2 under
    the causal mask, S^2 without it."""
    return S * (S + 1) / 2 if causal else float(S * S)


def flash_bound(shape, elem: int, causal: bool = True) -> dict:
    """q, k, v read once and out written once in the input type, lse in
    f32; 2 products of 2 hd flops for each (q, k) pair of each (b, h)
    (:func:`attention_pairs`), at the tensor-core rate of bf16 inputs."""
    B, S, H, hd = shape
    bytes_ = 4 * B * S * H * hd * elem + 4 * B * S * H
    flops = 4.0 * B * H * hd * attention_pairs(S, causal)
    return _bound(bytes_, flops, BF16_FLOPS_PER_S)


def flash_bwd_bound(shape, elem: int, causal: bool = True) -> dict:
    """q, k, v, out, dout read and dq, dk, dv written once in the input
    type, lse read in f32; five products (S, dP, dq, dk, dv) of 2 hd flops
    for each (q, k) pair of each (b, h) (:func:`attention_pairs`), at the
    tensor-core rate of bf16 inputs."""
    B, S, H, hd = shape
    bytes_ = 8 * B * S * H * hd * elem + 4 * B * S * H
    flops = 10.0 * B * H * hd * attention_pairs(S, causal)
    return _bound(bytes_, flops, BF16_FLOPS_PER_S)


def ssd_bound(shape, elem: int, chunk: int = MAX_CHUNK) -> dict:
    """x, B, C read and y written once in the input type, dt, A, state0
    read and the final state written once in f32; per chunk and head the
    Pallas body's four products (C.B^T, scores.x, C.S, B^T.x), at the
    tensor-core rate of bf16 inputs."""
    B, T, H, P, G, N = shape
    c = pick_chunk(T, chunk)
    bytes_ = (elem * (2 * B * T * H * P + 2 * B * T * G * N)
              + 4 * (B * T * H + H + 2 * B * H * N * P))
    flops = 2.0 * B * H * (T // c) * (c * c * N + c * c * P + 2 * c * N * P)
    return _bound(bytes_, flops, BF16_FLOPS_PER_S)


def ssd_bwd_bound(shape, elem: int, chunk: int = MAX_CHUNK) -> dict:
    """x, dy, B, C read and dx, dB, dC written once in the input type;
    dt, A, state0 read and ddt, dA, dstate0 written once in f32 (the train
    path's final-state gradient is None: not read); per chunk and head the
    products of the gradient (C.B^T, dy.x^T, and M, dG against dy, C, B:
    c x c x (3N + 2P)) and of the states (S dy_t, dS' x_s, dS'^T B_s, the
    dS and recomputed S updates: 5 c x N x P), at the tensor-core rate of
    bf16 inputs."""
    B, T, H, P, G, N = shape
    c = pick_chunk(T, chunk)
    bytes_ = (elem * (3 * B * T * H * P + 4 * B * T * G * N)
              + 4 * 2 * (B * T * H + H + B * H * N * P))
    flops = 2.0 * B * H * (T // c) * (c * c * (3 * N + 2 * P)
                                      + 5 * c * N * P)
    return _bound(bytes_, flops, BF16_FLOPS_PER_S)


def wkv_bound(shape, elem: int, rate: float = BF16_FLOPS_PER_S,
              chunk: int = MAX_CHUNK) -> dict:
    """r, k, v, w read and out written once in the input type, u and
    state0 read and the final state written once in f32; per chunk and head
    the Pallas body's four products (scores, scores.v, the readout, the
    state update), at ``rate`` (the tensor-core rate of bf16 inputs by
    default)."""
    B, T, H, N = shape
    c = pick_chunk(T, chunk)
    bytes_ = elem * 5 * B * T * H * N + 4 * (H * N + 2 * B * H * N * N)
    flops = 2.0 * B * H * (T // c) * (2 * c * c * N + 2 * c * N * N)
    return _bound(bytes_, flops, rate)


def wkv_bwd_bound(shape, elem: int, chunk: int = MAX_CHUNK) -> dict:
    """r, k, v, w, dout read and dr, dk, dv, dw written once in the input
    type; u, state0 read and du, dstate0 written once in f32 (no
    final-state gradient on the train path); per chunk and head the
    products of the gradient (scores, dout.v^T, their products with
    k_over, r_dec and dout: 5 c x c x N) and of the states (S dout_t,
    dS' v_s, dS'^T k_scaled, the dS and recomputed S updates: 5 c x N x
    N), at the tensor-core rate of bf16 inputs."""
    B, T, H, N = shape
    c = pick_chunk(T, chunk)
    bytes_ = elem * 9 * B * T * H * N + 4 * 2 * (H * N + B * H * N * N)
    flops = 2.0 * B * H * (T // c) * (5 * c * c * N + 5 * c * N * N)
    return _bound(bytes_, flops, BF16_FLOPS_PER_S)


# --------------------------------------------------------------------------- #
# Per call, from the op's arguments
# --------------------------------------------------------------------------- #

def norm_bound(shape, elem: int, delta: bool = False) -> dict:
    """RMSNorm of (rows, D): x read and y written once in the input type
    (and, with the residual add, delta read and h written once too), the
    f32 scale read once; a square, a sum and two products an element (and
    the add), on the CUDA cores."""
    rows, d = shape
    n = rows * d
    bytes_ = (4 if delta else 2) * n * elem + 4 * d
    flops = (5.0 if delta else 4.0) * n
    return _bound(bytes_, flops, FP32_FLOPS_PER_S)


def _ssd_shape(x, Bm) -> tuple:
    return (*x.shape, Bm.shape[2], Bm.shape[3])


def _ssd_workspace(shape, bf16: bool, chunk: int) -> int:
    """The f32 workspace :func:`mamba2_ssd_bwd` allocates on the card: on
    the bf16 cluster route (``mamba2_ssd.bwd_route``, tensors taken as
    aligned) the head groups' partial dB and dC and dA's partials; on the
    others the chunk states (twice on the mma.sync route), the per-head dB
    and dC, dA's partials. The card may pick a smaller chunk where shared
    memory asks for it; this counts the JAX chunk."""
    import torch
    from . import mamba2_ssd
    B, T, H, P, G, N = shape
    K = T // pick_chunk(T, chunk) if T else 0
    if bf16 and K and mamba2_ssd._bwd_route(shape, torch.bfloat16,
                                           (0, 0, 0, 0),
                                           chunk) == "cluster":
        groups = H // mamba2_ssd.cluster_heads(H)
        return 4 * (2 * B * T * groups * N + B * H * K)
    return 4 * (B * H * K * N * P * (2 if bf16 else 1) + 2 * B * T * H * N
                + B * H * (K if bf16 else 1))


def _wkv_workspace(shape, bf16: bool, chunk: int) -> int:
    """The f32 workspace :func:`rwkv6_wkv_bwd` allocates on the card: the
    chunk states (twice on the bf16 route) and du's partials."""
    B, T, H, N = shape
    K = T // pick_chunk(T, chunk) if T else 0
    return 4 * (B * H * K * N * N * (2 if bf16 else 1)
                + B * H * (K if bf16 else 1) * N)


def op_cost(op: str, args: Sequence) -> Dict[str, float]:
    """{"flops", "bytes", "workspace"} of one call of the kernel op
    ``op`` (``flash_fwd``, ``flash_bwd``, ``ssd_fwd``, ``ssd_bwd``,
    ``wkv_fwd``, ``wkv_bwd``, ``rms_norm``, ``add_rms_norm``) on ``args``,
    its positional arguments (tensors, or anything with ``.shape`` and
    ``.dtype``)."""
    elem = args[0].dtype.itemsize
    bf16 = elem == 2
    work = 0
    if op == "flash_fwd":        # (q, k, v, causal); causal if left out
        b = flash_bound(tuple(args[0].shape), elem,
                        bool(args[3]) if len(args) > 3 else True)
    elif op == "flash_bwd":      # (q, k, v, out, lse, dout, causal)
        b = flash_bwd_bound(tuple(args[0].shape), elem,
                            bool(args[6]) if len(args) > 6 else True)
        work = 4 * args[4].numel()                      # delta (B, S, H)
    elif op == "ssd_fwd":
        b = ssd_bound(_ssd_shape(args[0], args[3]), elem, args[6])
    elif op == "ssd_bwd":
        shape = _ssd_shape(args[0], args[3])
        b = ssd_bwd_bound(shape, elem, args[8])
        work = _ssd_workspace(shape, bf16, args[8])
    elif op == "wkv_fwd":
        b = wkv_bound(tuple(args[0].shape), elem, chunk=args[6])
    elif op == "wkv_bwd":
        shape = tuple(args[0].shape)
        b = wkv_bwd_bound(shape, elem, args[8])
        work = _wkv_workspace(shape, bf16, args[8])
    elif op in ("rms_norm", "add_rms_norm"):
        shape = tuple(args[0].shape)
        b = norm_bound((math.prod(shape[:-1]), shape[-1]), elem,
                       op == "add_rms_norm")
    else:
        raise KeyError(f"no cost for kernel op {op!r}")
    return {"flops": b["flops"], "bytes": b["bytes"], "workspace": work}
