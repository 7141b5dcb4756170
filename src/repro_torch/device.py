"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to CUDA. There
is no fallback: asking for CUDA where ``torch.cuda.is_available()`` is
False raises, so a run that was meant for the card can never quietly
compute on the CPU. Tests and CPU runs pass ``device="cpu"``.

:func:`virtual_devices` splits one device into lanes, each a distinct
place with its own CUDA stream, so the sharded tier can run a mesh on one
card as the JAX package runs one on forced host devices. Nothing makes
them unless a caller asks.
"""

from __future__ import annotations

import threading
from typing import Any, List, Union

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


class VirtualDevice:
    """One lane of a physical device: the counterpart of one of the host
    devices that ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
    gives the JAX package.

    Lanes of one device are distinct places (hashable and equal by
    ``(device, lane)``), so the sharded tier can build a mesh of them on a
    single card. ``.device`` is the physical ``torch.device``; ``.stream``
    is a CUDA stream of the lane's own on a CUDA device (made at first use,
    never while planning) and ``None`` on the CPU, where lanes run one
    after another.
    """

    __slots__ = ("device", "lane", "_stream", "_lock")

    def __init__(self, device: DeviceLike, lane: int) -> None:
        self.device = torch.device(device)
        self.lane = int(lane)
        self._stream = None
        self._lock = threading.Lock()

    @property
    def stream(self):
        if self.device.type != "cuda":
            return None
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=self.device)
            return self._stream

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, VirtualDevice)
                and (self.device, self.lane) == (other.device, other.lane))

    def __hash__(self) -> int:
        return hash((VirtualDevice, self.device, self.lane))

    def __repr__(self) -> str:
        return f"VirtualDevice({str(self.device)!r}, {self.lane})"

    def __str__(self) -> str:
        return f"{self.device}/lane{self.lane}"


def virtual_devices(device: DeviceLike, n: int) -> List[VirtualDevice]:
    """``n`` lanes of ``device``, resolved as :func:`resolve_device` does
    (CUDA without a card raises). Nothing builds them unless a caller asks:
    they are for tests and the card check, as the forced host device count
    is for the JAX package's; ``TorchRTS()`` lists real cards only."""
    if n < 1:
        raise ValueError(f"virtual_devices needs n >= 1, got {n}")
    dev = resolve_device(device)
    return [VirtualDevice(dev, i) for i in range(n)]


def place_device(place: Any) -> torch.device:
    """The physical ``torch.device`` of a place: a lane's device, or the
    device itself."""
    if isinstance(place, VirtualDevice):
        return place.device
    return torch.device(place)
