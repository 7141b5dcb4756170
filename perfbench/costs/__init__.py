"""The benchmark's yardstick: the published peaks of the card, and the least
time of a kernel call from its shape alone.

The work of each kernel of the program is a module of this package named
as the program names the kernel (``repro_torch.kernels.KERNELS``), which
gives ``cost(shape, elem)``: the bytes and operations of one call. Each is
a frozen copy of the formula in the port's ``kernels/costs.py``, kept here
so that a change to the program cannot move the ruler it is measured with;
``perfbench/tests/test_perfbench_costs.py`` holds the copy to the port at
every shape the cells run.

Peaks: one NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA data sheet,
dense rates).
"""

from __future__ import annotations

import importlib

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def bound(bytes_: float, flops: float, rate: float = BF16_FLOPS_PER_S
          ) -> dict:
    """The least time of ``bytes_`` moved and ``flops`` done at ``rate``:
    the larger of the two times."""
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / rate
    return {"bytes": bytes_, "flops": flops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_cost(kernel: str):
    """``cost(shape, elem)`` of the program's kernel ``kernel``."""
    return importlib.import_module(f"{__name__}.{kernel}").cost


def kernel_bound_s(kernel: str, shapes: dict, elem: int = 2) -> float:
    """Σ over calls of the least time of ``kernel``; ``shapes`` maps a
    call's shape to its count."""
    cost = kernel_cost(kernel)
    return sum(n * cost(tuple(s), elem)["bound_s"] for s, n in shapes.items())
