"""The JAX package's parameters and train state, turned into numpy by the
caller, as the port's dicts of tensors with the same keys, shapes and
dtypes.

numpy has no bfloat16 of its own: JAX's bf16 arrays come out as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses. Their bits are
carried over unchanged through a uint16 view.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def tensor_from_numpy(a: np.ndarray, device: DeviceLike = None
                      ) -> torch.Tensor:
    """One array → a tensor on ``device``, bit for bit (bf16 included)."""
    dev = resolve_device(device)
    a = np.array(a)     # a writable, contiguous copy (JAX's are read-only)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None
                      ) -> Dict[str, Any]:
    """A nested dict of numpy arrays → the same dict of tensors."""
    dev = resolve_device(device)
    return {k: params_from_numpy(v, dev) if isinstance(v, dict)
            else tensor_from_numpy(v, dev) for k, v in tree.items()}


def train_state_from_numpy(state: Dict[str, Any], device: DeviceLike = None
                           ) -> Dict[str, Any]:
    """The JAX train state ``{"params", "opt": {"m", "v", "step"}}`` as
    numpy → the port's (f32 masters and moments, the step a 0-d int32
    tensor), on ``device``."""
    if set(state) != {"params", "opt"} or set(state["opt"]) != {
            "m", "v", "step"}:
        raise ValueError("a train state is {'params', 'opt': {'m', 'v', "
                         "'step'}}")
    return params_from_numpy(state, device)
