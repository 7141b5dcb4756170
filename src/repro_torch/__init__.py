"""repro_torch — the ensemble toolkit on PyTorch and CUDA.

A second package beside the JAX one (``src/repro``), with the same layout
and names, so every module's counterpart sits at the same relative path.
It imports ``torch`` and numpy and never ``jax`` or anything of the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for CUDA on a machine without it raises
(:func:`repro_torch.device.resolve_device`).

Copied verbatim from ``src/repro`` (they hold no arrays and touch no
device; every import inside them is package-relative):

* ``core/`` — all 15 modules (``src/repro/core/*.py``);
* ``api/`` — all 6 modules (``src/repro/api/*.py``);
* ``telemetry/`` — all 4 modules (``src/repro/telemetry/*.py``);
* ``rts/{__init__,base,local,federation,platforms,simulated}.py``
  (``src/repro/rts/``);
* ``fusion/{__init__,groups,plans}.py`` (``src/repro/fusion/``).

Process-global registries (executables, result codecs, telemetry kernel
labels) are therefore separate objects in the two packages.

Ported (the modules that touch arrays or devices):

* :mod:`repro_torch.device` — device resolution, no silent CPU fallback;
* :mod:`repro_torch.kernels.anen_distance` — the analog-similarity
  distance as a hand-written CUDA kernel (``kernels/csrc/``) with its
  plain PyTorch version, built by :mod:`repro_torch.kernels._build`;
* :mod:`repro_torch.fusion.handles` — tensor-backed result handles;
* :mod:`repro_torch.fusion.engine` — scalar and per-stage fused tiers;
* :mod:`repro_torch.rts.torch_rts` — :class:`TorchRTS`, the device RTS;
* :mod:`repro_torch.apps.anen` — the AnEn numerics and adaptive workflow.
"""
