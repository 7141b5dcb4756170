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
* ``fusion/{__init__,groups,plans}.py`` (``src/repro/fusion/``);
* ``chaos/__init__.py`` — the seeded chaos plane
  (``src/repro/chaos/__init__.py``);
* ``serve/{admission,fair_share,journal,protocol,client,daemon}.py``
  (``src/repro/serve/``);
* ``data/{__init__,pipeline}.py`` — the deterministic synthetic LM stream
  and its prefetcher (numpy only; ``src/repro/data/``).

Of these the port has since made its own ``telemetry/`` (spans from every
thread while a ``torch.profiler`` records, on the profiler's clock, with
each span's parent and task uid), ``rts/local.py`` (spans on the scheduler
and worker threads) and ``core/{wfprocessor,profiler}.py`` (a span around
``post_exec``; unread counters and events taken out): each keeps every
function and class of its original but those it took out
(``tests/test_torch_verbatim.py``).

Process-global registries (executables, result codecs, telemetry kernel
labels) are therefore separate objects in the two packages.

Ported (the modules that touch arrays or devices):

* :mod:`repro_torch.device` — device resolution, no silent CPU fallback,
  and virtual devices (lanes of one device, each with its own CUDA
  stream: the counterpart of JAX's forced host device count);
* :mod:`repro_torch.kernels.anen_distance` — the analog-similarity
  distance as a hand-written CUDA kernel (``kernels/csrc/``) with its
  plain PyTorch version, built by :mod:`repro_torch.kernels._build`, and
  its sharded form over a mesh of places (B1's kernel once a place);
* :mod:`repro_torch.fusion.handles` — tensor-backed result handles,
  sharded values and both sides of the JAX package's sharded spill
  records;
* :mod:`repro_torch.fusion.engine` — the scalar, per-stage fused, chain
  (composed ``vmap`` links), DAG (masked device reductions in the
  composed segment) and sharded tiers (the member axis split over a mesh
  of cards or lanes, one launch a place on its own stream, each place's
  link a CUDA graph captured once a shape and replayed, reductions
  combined from the places' partials);
* :mod:`repro_torch.rts.torch_rts` — :class:`TorchRTS`, the device RTS,
  with the chain, DAG and shard carriers' assembly, the shard hold
  buffer, and the serving mode's continuous-batching window, tenant
  interleaving and per-tenant accounting;
* :mod:`repro_torch.serve.service` — :class:`EnsembleService` over
  :class:`TorchRTS` on ``device`` (``serve/__init__.py`` exports what the
  JAX package's does);
* :mod:`repro_torch.apps.anen` — the AnEn numerics and adaptive workflow,
  each round one DAG carrier;
* :mod:`repro_torch.apps.seismic` — the seismic solver (forward, misfit,
  adjoint gradient by autograd) and its forward, misfit-ensemble and
  misfit-chain workflows;
* :mod:`repro_torch.models` and :mod:`repro_torch.configs` — the model
  registry (all ten configurations) and, end to end in the JAX package's
  parameter layout, every family: hybrid (zamba2), ``ssm`` (rwkv6) and
  the attention stack (dense, ``moe``, vlm, audio);
* :mod:`repro_torch.kernels.flash_attention`,
  :mod:`repro_torch.kernels.mamba2_ssd`,
  :mod:`repro_torch.kernels.rwkv6_wkv` — the model kernels as
  hand-written CUDA with their plain PyTorch versions; each also has its
  backward as a CUDA kernel behind an ``autograd.Function``; flash
  attention in both of the JAX kernel's modes, causal and full
  (``causal=False``), forward and backward; oracles in
  :mod:`repro_torch.kernels.ref`;
* :mod:`repro_torch.launch.serve` — batched prefill + greedy decode as
  EnTK tasks over :class:`TorchRTS`;
* :mod:`repro_torch.optim`, :mod:`repro_torch.checkpoint` and
  :mod:`repro_torch.launch.train` — AdamW (in place), the checkpoint
  store in the JAX package's layout with its sharded form (DTensor
  leaves saved as their global arrays, ``shard_filter`` for the leaves a
  host owns, ``shardings`` to restore onto a ``DeviceMesh`` of any
  size), and the EnTK-managed, checkpointed
  trainer over :class:`TorchRTS` (int8 gradient compression, with its
  mean over a data axis as an ``all_reduce`` over a ``torch.distributed``
  group named by a ``DeviceMesh`` dimension).
"""
