"""The kernels as ``torch.library`` ops: one op a CUDA launcher.

Each wrapper calls its op (``repro_torch::flash_fwd`` and so on). The op's
implementation is the wrapper's device path as it was: the plain version
for CPU tensors, one counted launch for CUDA tensors. What the op adds is
what runs without computing:

* a fake implementation (fake tensors, and meta tensors handed to the op
  itself; the wrappers keep refusing a meta device): outputs of the
  right shapes and dtypes, nothing computed, nothing counted;
* a FLOP formula for ``torch.utils.flop_counter`` (:mod:`.costs`);
* DTensor sharding rules (batch on the data axes, heads on the model
  axis, computed locally), registered by :func:`register_sharding` the
  first time an activation-sharding context is entered.

So a step traced on fake tensors, or on DTensors of fake tensors, passes
each kernel as one op with its cost (:mod:`repro_torch.launch.op_analysis`)
instead of unrolling a plain version's Python loops.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

import torch
from torch.utils.flop_counter import register_flop_formula

from .costs import op_cost

NAMESPACE = "repro_torch"
# op name → a function of the op's args giving its DTensor strategies
_SHARDING: Dict[str, Callable] = {}
_registered = False
_lock = threading.Lock()


class _Meta:
    """A shape as FlopCounterMode hands it over, dressed as a tensor."""

    def __init__(self, shape) -> None:
        self.shape = tuple(shape)
        self.dtype = torch.bfloat16

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


# the ops' definitions live as long as the process (a dropped Library
# takes its registrations with it)
_LIB = torch.library.Library(NAMESPACE, "DEF")


def kernel_op(name: str, fake: Callable, sharding: Callable):
    """Decorator: the function becomes the op ``repro_torch::name`` (its
    schema from the annotations), the implementation for CPU and CUDA
    tensors, with ``fake`` as its fake implementation, :func:`costs.op_cost`'s
    flops as its FLOP formula and ``sharding`` (args → list of (output
    placements, input placements)) as its DTensor rule. It is defined with
    ``torch.library.Library`` rather than ``custom_op``, whose first call
    imports ``torch._dynamo`` (seconds on the card's host)."""
    def deco(fn):
        _LIB.define(name + torch.library.infer_schema(fn, mutates_args=()))
        for key in ("CPU", "CUDA"):
            _LIB.impl(name, fn, key)
        torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
        packet = getattr(torch.ops.repro_torch, name)

        def flops(*args, out_shape=None, **kwargs):
            return int(op_cost(name, [
                _Meta(a) if isinstance(a, (tuple, list, torch.Size))
                else a for a in args])["flops"])
        register_flop_formula(packet)(flops)
        _SHARDING[name] = sharding
        return packet.default
    return deco


def register_sharding() -> None:
    """Register every kernel op's DTensor sharding rule (once)."""
    global _registered
    with _lock:
        if _registered:
            return
        from torch.distributed.tensor.experimental import \
            register_sharding as reg
        for name, rule in _SHARDING.items():
            reg(getattr(torch.ops.repro_torch, name).default)(rule)
        _registered = True


def _is_tensor(a) -> bool:
    return not isinstance(a, (bool, int, float, type(None)))


def strategies(args, n_out: int, **named) -> list:
    """DTensor strategies of an op called on ``args``: all replicated,
    then one a named sharding, given as (output dims, input dims): a dim
    an index (``Shard``), None (``Replicate``) or ``"P"`` (a partial sum,
    for a gradient summed over the sharded dim); an input that is not a
    tensor gets no placement whatever its entry."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def pl(d):
        if d == "P":
            return Partial()
        return Replicate() if d is None else Shard(d)
    tensor = [_is_tensor(a) for a in args]
    out = [([Replicate()] * n_out,
            [Replicate() if t else None for t in tensor])]
    for outs, ins in named.values():
        out.append(([pl(d) for d in outs],
                    [pl(d) if t else None for d, t in zip(ins, tensor)]))
    return out
