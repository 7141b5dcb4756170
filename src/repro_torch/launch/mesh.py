"""Device meshes for the H100 port: axis names and sizes, plus an optional
``torch.distributed`` ``DeviceMesh``.

A :class:`Mesh` reads like the JAX package's ``jax.sharding.Mesh`` where the
sharding rules look (``mesh.shape[name]``, ``mesh.axis_names``), so the
rules of :mod:`repro_torch.models.sharding` take either. The
``DeviceMesh`` is attached by the code that runs on one
(:mod:`repro_torch.launch.dryrun` over a fake process group); building a
:class:`Mesh` touches no process group and no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_mesh: Optional[Any] = None   # a torch DeviceMesh, when built

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def with_device_mesh(self, device_mesh: Any) -> "Mesh":
        return dataclasses.replace(self, device_mesh=device_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production meshes, as H100 clusters of the JAX package's device
    counts (its TPU pod shapes do not carry over).

    Single: 256 GPUs as (data=32, model=8). Multi: 512 GPUs as (pod=2,
    data=32, model=8). The model axis stays inside one 8-GPU NVLink node,
    which is where tensor parallelism runs on H100 clusters; the data and
    pod axes cross the InfiniBand network (batch-parallel and FSDP only)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 32, 8))
    return Mesh(("data", "model"), (32, 8))


def make_mesh_for(devices_or_count, model_axis: int = 1,
                  axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """A (data, model) mesh over ``devices_or_count`` (a count or a list of
    devices) with the requested TP degree, clamped down to a divisor of the
    device count (the JAX package's elastic re-mesh rule)."""
    n = (devices_or_count if isinstance(devices_or_count, int)
         else len(list(devices_or_count)))
    tp = model_axis
    while n % tp:
        tp -= 1
    return Mesh(tuple(axis_names), (n // tp, tp))
