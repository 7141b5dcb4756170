"""Roofline terms of a PyTorch step, counted op by op as it runs.

The counterpart of the JAX package's ``launch/hlo_analysis.py``. PyTorch
has no compiled module to read, so the counts come from the ops
themselves: :class:`OpAnalysis` is a ``TorchDispatchMode`` that sees every
ATen op, kernel op and collective a step issues and counts, **per
device**, on local shard shapes (under DTensor it steps aside for the
DTensor dispatch and counts the local ops that dispatch issues):

* **flops**: matmuls and convolutions by ``torch.utils.flop_counter``'s
  formulas; the hand-written kernels (``repro_torch::*`` ops) by their
  formulas in :mod:`repro_torch.kernels.costs`, each call one launch;
  every other op 1 per output element, as JAX's ``analyze`` counts them.
  Views and allocations are free.
* **bytes**: the operands plus the results of each op. Eager PyTorch
  fuses nothing, so this counts more than XLA's post-fusion bytes: an
  upper bound on a fused program's traffic, not a prediction of it.
* **collective bytes**: the DTensor collectives, with JAX's ring factors:
  all-gather R·(n−1)/n, all-reduce 2·O·(n−1)/n, reduce-scatter and
  all-to-all O·(n−1)/n. They are split by mesh axis: the model axis runs
  over NVLink inside a node, the data and pod axes over the network.

It also tracks memory: the live bytes of every storage the step's ops
create (the tracked inputs' too), and their peak, with each kernel call's
f32 workspace added while it runs. On fake tensors this is the step's
peak device memory as the caching allocator would count it, less its
rounding and the temporaries inside library kernels.

:func:`roofline_terms` turns the counts into seconds with the published
peaks of one NVIDIA H100 SXM5 80GB: 989e12 bf16 dense FLOP/s, 3.35e12 B/s
of HBM3, 450e9 B/s of NVLink each way, and 50e9 B/s for a GPU on a
400 Gb/s NDR InfiniBand link. These are spec-sheet figures, not
measurements.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels.costs import BF16_FLOPS_PER_S, HBM_BYTES_PER_S, op_cost

# published peaks of one H100 SXM5 80GB (NVIDIA data sheet): spec-sheet
# figures, not measurements
PEAK_FLOPS = BF16_FLOPS_PER_S      # bf16 dense FLOP/s
HBM_BW = HBM_BYTES_PER_S           # bytes/s
NVLINK_BW = 450e9                  # bytes/s each way, NVLink 4 (18 links)
NETWORK_BW = 50e9                  # bytes/s a GPU, 400 Gb/s NDR InfiniBand

KERNEL_NAMESPACE = "repro_torch"
# the mesh axes whose collectives stay inside one NVLink node
NVLINK_AXES = ("model",)

_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")
_FREE = {"detach", "empty", "empty_like", "empty_strided", "lift_fresh",
         "alias", "_local_scalar_dense", "device", "is_same_size",
         "wait_tensor", "clone_preserve_strides", "set_", "resize_",
         "_unsafe_view", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "_has_compatible_shallow_copy_type"}


class _Depth(threading.local):
    depth = 0


_PROPAGATING = _Depth()


@contextlib.contextmanager
def ignoring_sharding_propagation():
    """While DTensor infers an op's output shapes it runs the op on fakes
    of the global shapes (of the step's fake mode too): those runs are not
    the step's, and :class:`OpAnalysis` passes them through uncounted and
    untracked inside this context."""
    from torch.distributed.tensor import _sharding_prop as sp
    cls = sp.ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(cls, name, None)
    if orig is None:
        yield
        return

    def wrapped(self, *args, **kwargs):
        _PROPAGATING.depth += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1
    setattr(cls, name, wrapped)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t):
    """A DTensor's local shard, or the tensor itself."""
    return getattr(t, "_local_tensor", t)


class OpAnalysis(TorchDispatchMode):
    """Count flops, bytes, collective bytes, kernel launches and live
    memory of everything run under it (see the module docstring).

    ``fake_mode``: the ``FakeTensorMode`` of the step's tensors; ops on
    fake tensors of any other mode (DTensor's own sharding propagation
    runs ops on global-shape fakes) are not the step's and are passed
    through uncounted. ``mesh``: the :class:`~repro_torch.launch.mesh.Mesh`
    whose device mesh's groups name the axes of the collectives."""

    def __init__(self, mesh=None, fake_mode=None) -> None:
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes = 0.0
        self.collective_detail: Dict[str, float] = collections.defaultdict(
            float)
        self.collective_by_axis: Dict[str, float] = collections.defaultdict(
            float)
        self.matmul_flops = 0.0
        self.kernel_flops = 0.0
        self.launches: Dict[str, int] = collections.Counter()
        self.by_op: Dict[str, list] = collections.defaultdict(
            lambda: [0, 0.0, 0.0])          # calls, flops, bytes
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, Any] = {}
        self._axis_of: Dict[str, str] = {}
        dm = getattr(mesh, "device_mesh", None)
        if dm is not None:
            for i, name in enumerate(mesh.axis_names):
                self._axis_of[dm.get_group(i).group_name] = name

    # -- memory ------------------------------------------------------------

    def track(self, *trees) -> None:
        """Count the storages of tensors that exist before the step (its
        state and inputs; a DTensor by its local shard) as live."""
        for tree in trees:
            for t in _tensors(tree):
                self._add(_local(t))

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        self._storages[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._storages.pop(key, None)

    # -- dispatch ------------------------------------------------------------

    def _ours(self, tensors) -> bool:
        if self.fake_mode is None:
            return True
        # DTensor's sharding propagation runs ops on meta tensors and on
        # fakes of its own mode: only fakes of the step's mode count
        return all(getattr(t, "fake_mode", None) is self.fake_mode
                   for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _PROPAGATING.depth:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not self._ours(ins + outs):
            return out
        work = self._count(func, args, kwargs, ins, outs, out)
        for t in outs:
            self._add(t)
        if work:
            self.peak = max(self.peak, self.live + work)
        return out

    def _count(self, func, args, kwargs, ins, outs, out) -> int:
        ns = func.namespace
        name = func._opname
        key = f"{ns}.{name}"
        row = self.by_op[key]
        row[0] += 1
        if ns == KERNEL_NAMESPACE:
            cost = op_cost(name, args)
            self.launches[name] += 1
            self.kernel_flops += cost["flops"]
            self._add_cost(row, cost["flops"], cost["bytes"])
            return int(cost["workspace"])
        if ns in _COLLECTIVE_NS:
            self._collective(name, args, ins, outs)
            return 0
        if name in _FREE or func.is_view or ns == "prim":
            return 0
        io = sum(_nbytes(t) for t in ins)
        if not func._schema.is_mutable:
            io += sum(_nbytes(t) for t in outs)
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            self.matmul_flops += flops
        else:                        # elementwise-ish, fills too
            flops = float(sum(t.numel() for t in outs))
        self._add_cost(row, flops, io)
        return 0

    def _add_cost(self, row, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row[1] += flops
        row[2] += nbytes

    def _collective(self, name: str, args, ins, outs) -> None:
        if name in ("wait_tensor",) or not ins:
            return
        # the group's name is the last string argument (a reduce op, when
        # there is one, comes before it)
        group = next((a for a in reversed(args) if isinstance(a, str)),
                     None)
        n = _group_size(group)
        factor = (n - 1) / n if n > 1 else 0.0
        o = _nbytes(ins[0])
        r = _nbytes(outs[0]) if outs else o
        if name.startswith("all_gather"):
            wire, kind = r * factor, "all-gather"
        elif name.startswith("all_reduce"):
            wire, kind = 2.0 * o * factor, "all-reduce"
        elif name.startswith("reduce_scatter"):
            wire, kind = o * factor, "reduce-scatter"
        elif "all_to_all" in name or "alltoall" in name:
            wire, kind = o * factor, "all-to-all"
        else:                        # broadcast, permute: the result
            wire, kind = float(r), name
        axis = self._axis_of.get(group, "?")
        self.collective_bytes += wire
        self.collective_detail[f"{kind}@{axis}:{n}"] += wire
        self.collective_by_axis[axis] += wire

    # -- results -------------------------------------------------------------

    def per_device(self) -> Dict[str, Any]:
        """The counts, as JAX's ``analyze`` returns them, plus the split by
        link, the kernels' launches and the memory peak."""
        nvlink = sum(v for a, v in self.collective_by_axis.items()
                     if a in NVLINK_AXES)
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "collective_detail": dict(self.collective_detail),
                "collective_bytes_nvlink": nvlink,
                "collective_bytes_network": self.collective_bytes - nvlink,
                "matmul_flops": self.matmul_flops,
                "kernel_flops": self.kernel_flops,
                "launches": dict(self.launches),
                "peak_bytes": self.peak}


def _group_size(group_name: Optional[str]) -> int:
    if group_name is None:
        return 1
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


def analyze(fn, *args, mesh=None, fake_mode=None, track=(),
            **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` under :class:`OpAnalysis` (``track``:
    trees whose tensors are live before the call) → its per-device
    counts."""
    mode = OpAnalysis(mesh=mesh, fake_mode=fake_mode)
    mode.track(*track)
    with mode:
        fn(*args, **kwargs)
    return mode.per_device()


def top_contributors(analysis: OpAnalysis, n: int = 20,
                     key: str = "bytes") -> list:
    """The ops with the most ``key`` ("flops" or "bytes") over the run:
    [(total, op, calls)], largest first."""
    col = {"flops": 1, "bytes": 2}[key]
    rows = [(row[col], op, row[0]) for op, row in analysis.by_op.items()
            if row[col]]
    rows.sort(reverse=True)
    return rows[:n]


def roofline_terms(per_device: Dict[str, float]) -> Dict[str, Any]:
    """Seconds per step for each roofline term, from per-device counts:
    the collective term is the NVLink bytes over NVLink plus the network
    bytes over the network (all of them at the network rate when the
    counts carry no split)."""
    t_compute = per_device["flops"] / PEAK_FLOPS
    t_memory = per_device["bytes"] / HBM_BW
    nvlink = per_device.get("collective_bytes_nvlink", 0.0)
    network = per_device.get("collective_bytes_network",
                             per_device["collective_bytes"] - nvlink)
    t_nvlink = nvlink / NVLINK_BW
    t_network = network / NETWORK_BW
    t_collective = t_nvlink + t_network
    dominant = max(
        ("compute", t_compute), ("memory", t_memory),
        ("collective", t_collective), key=lambda kv: kv[1])[0]
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_collective,
            "t_collective_nvlink": t_nvlink,
            "t_collective_network": t_network,
            "dominant": dominant,
            "step_time_lower_bound": max(t_compute, t_memory,
                                         t_collective)}


def matmul_flops_of(fn: Callable, *args, **kwargs) -> float:
    """The matmul and convolution FLOPs ``torch.utils.flop_counter``'s
    ``FlopCounterMode`` counts for ``fn(*args, **kwargs)``, the kernel ops
    left out: the yardstick of :attr:`OpAnalysis.matmul_flops`."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    total = 0
    for op, n in counter.get_flop_counts()["Global"].items():
        name = getattr(op, "_qualified_op_name", str(op))
        if not name.startswith(KERNEL_NAMESPACE + "::"):
            total += n
    return float(total)
