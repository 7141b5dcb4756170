"""Int8 gradient compression with error feedback.

The JAX package's scheme (``optim/compression.py``), op for op: gradients
are quantized to int8 with a per-block f32 scale before the cross-replica
mean, and the quantization error is fed back into the next step's gradient
(error feedback keeps convergence: Karimireddy et al. 2019). Blocks of
``BLOCK`` values, the scale floored at 1e-12, values rounded half to even
(``torch.round``, as ``jnp.round``) and clipped to ±127: the same int8
blocks and the same scale bits as JAX for the same input.

Gradients and error states are the port's nested dicts of tensors. The
mean over a data axis (JAX's ``pmean`` under ``shard_map``) needs a
``torch.distributed`` process group, one rank a card, which the port does
not take yet (``ROADMAP.md`` A12f): :func:`ef_compressed_mean` with an
``axis_name`` raises.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

BLOCK = 2048


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    flat = F.pad(x.reshape(-1), (0, (-n) % BLOCK))
    return flat.reshape(-1, BLOCK), n


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (int8 blocks (n_blocks, BLOCK), f32 per-block scales
    (n_blocks, 1))."""
    blocks, _ = _pad_to_block(g.float())
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds differently from the CPU and XLA
    scale = blocks.abs().amax(dim=1, keepdim=True) / blocks.new_full(
        (), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= int(s)
    return flat[:n].reshape(tuple(shape)).to(dtype)


def _map2(fn, a: Any, b: Any):
    """``fn`` over the leaves of two dicts of one structure → two dicts."""
    if isinstance(a, dict):
        pairs = {k: _map2(fn, a[k], b[k]) for k in a}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return fn(a, b)


def ef_compressed_mean(grads: Any, error: Any,
                       axis_name: Optional[str] = None) -> Tuple[Any, Any]:
    """Error-feedback int8 compression of a gradient dict.

    Returns (decompressed grads in each gradient's dtype, new f32 error
    state). ``axis_name`` names the data axis whose mean the int8 payload
    would cross: that needs a ``torch.distributed`` group, not taken yet."""
    if axis_name is not None:
        raise NotImplementedError(
            f"ef_compressed_mean(axis_name={axis_name!r}): the mean over a "
            f"data axis needs a torch.distributed process group (one rank "
            f"a card), which the port does not take yet (ROADMAP.md A12f)")

    def one(g, e):
        target = g.float() + e
        q, s = compress_int8(target)
        deq = decompress_int8(q, s, g.shape)
        return deq.to(g.dtype), target - deq

    return _map2(one, grads, error)


def init_error(params: Any) -> Any:
    """Zero f32 error state of ``params``' structure, on their devices."""
    if isinstance(params, dict):
        return {k: init_error(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)
