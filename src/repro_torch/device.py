"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to CUDA. There
is no fallback: asking for CUDA where ``torch.cuda.is_available()`` is
False raises, so a run that was meant for the card can never quietly
compute on the CPU. Tests and CPU runs pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the current CUDA device; ``"cuda"``/``"cuda:i"``/``"cpu"``
    → that device. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested (the default device of repro_torch) but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} requested, but only "
                               f"{torch.cuda.device_count()} CUDA devices")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def device_name(device: DeviceLike = None) -> str:
    """JSON-able name of the resolved device (``"cuda:0"``, ``"cpu"``):
    the form a device takes as a static task argument."""
    return str(resolve_device(device))
