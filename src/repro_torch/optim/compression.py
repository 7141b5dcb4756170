"""Int8 gradient compression with error feedback.

The JAX package's scheme (``optim/compression.py``), op for op: gradients
are quantized to int8 with a per-block f32 scale before the cross-replica
mean, and the quantization error is fed back into the next step's gradient
(error feedback keeps convergence: Karimireddy et al. 2019). Blocks of
``BLOCK`` values, the scale floored at 1e-12, values rounded half to even
(``torch.round``, as ``jnp.round``) and clipped to ±127: the same int8
blocks and the same scale bits as JAX for the same input.

Gradients and error states are the port's nested dicts of tensors. The
mean over a data axis (JAX's ``pmean`` under ``shard_map``) is an
``all_reduce`` over a ``torch.distributed`` group, one rank a replica:
``axis_name`` names a dimension of the ``DeviceMesh`` the caller passes
(or of a :class:`~repro_torch.launch.mesh.Mesh`'s ``device_mesh``), and
with no mesh the default group.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
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


def _axis_group(axis_name: str, mesh: Any):
    """The process group of ``axis_name``: a dimension of ``mesh`` (a
    ``DeviceMesh``, or a port ``Mesh`` carrying one), or the default group
    when no mesh is given."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"ef_compressed_mean(axis_name={axis_name!r}) needs an "
            f"initialised torch.distributed process group")
    if mesh is None:
        return None
    device_mesh = getattr(mesh, "device_mesh", mesh)
    if device_mesh is None:
        raise ValueError(f"mesh {mesh!r} carries no DeviceMesh")
    return device_mesh.get_group(axis_name)


def ef_compressed_mean(grads: Any, error: Any,
                       axis_name: Optional[str] = None, *,
                       mesh: Any = None) -> Tuple[Any, Any]:
    """Error-feedback int8 compression of a gradient dict.

    Returns (decompressed grads in each gradient's dtype, new f32 error
    state). With ``axis_name`` the dequantized int8 payload is averaged
    over that axis's group (JAX's ``pmean``): the error stays rank-local,
    the f32 payload is summed by ``all_reduce`` and divided by the group's
    size, and only then cast to the gradient's dtype."""
    group = None if axis_name is None else _axis_group(axis_name, mesh)

    def one(g, e):
        target = g.float() + e
        q, s = compress_int8(target)
        deq = decompress_int8(q, s, g.shape)
        new_e = target - deq
        if axis_name is not None:
            dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
            deq = deq / deq.new_full((), dist.get_world_size(group))
        return deq.to(g.dtype), new_e

    return _map2(one, grads, error)


def init_error(params: Any) -> Any:
    """Zero f32 error state of ``params``' structure, on their devices."""
    if isinstance(params, dict):
        return {k: init_error(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)
