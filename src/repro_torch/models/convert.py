"""The JAX package's parameters, turned into numpy by the caller, as the
port's dict of tensors with the same keys, shapes and dtypes.

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
