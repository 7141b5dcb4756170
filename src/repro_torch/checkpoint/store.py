"""Atomic, async-capable checkpoint store in the JAX package's layout.

A checkpoint written by either package restores in the other:

* **Atomicity** — a checkpoint is written to ``step_<n>.tmp/`` and renamed
  to ``step_<n>/`` only after every leaf and the manifest are on disk; a
  crash mid-write never corrupts the latest valid checkpoint.
* **Layout** — ``step_%08d/manifest.json`` holds ``step``, ``leaves``
  (file, shape and dtype of each) and ``extra``; each leaf of the nested
  dict is its own ``.npy``, named by its dict path with ``/`` → ``__``
  (``params/blocks/attn/wq`` → ``params__blocks__attn__wq.npy``).
  A ``bfloat16`` leaf is stored as the JAX store stores one (its 2-byte
  elements as ``V2``, ``"bfloat16"`` in the manifest).
* **Sharded layout** — a DTensor leaf is saved as its global array, as
  the JAX store saves a sharded ``jax.Array``: every rank gathers every
  DTensor leaf (``full_tensor()``, a collective), in the same sorted-name
  order, before anything else happens to it. On a multi-host run each
  host then writes only the leaves it owns (``shard_filter``: a leaf whose
  name it refuses is neither written nor listed in the manifest).
  ``restore`` with ``shardings`` (a nested dict shaped like the tree,
  each leaf ``None`` or a ``(DeviceMesh, placements)`` pair, the
  counterpart of a ``NamedSharding``; ``models/sharding.py::named`` gives
  the placements) makes each such leaf a DTensor of that layout: every
  rank reads the whole array and keeps its own shard, on its device, with
  no communication. The mesh need not be the one that saved: an *elastic*
  resume onto another mesh.
* **Async** — ``CheckpointManager.save_async`` copies every leaf to host
  memory synchronously (device→host, so a later in-place update cannot
  reach the snapshot; a DTensor leaf gathered on the caller's thread, never
  on the writer thread) and writes to disk on a background thread.
* **Retention** — keep the newest ``keep`` checkpoints.

``restore`` places the leaves without a sharding on the device it is
given.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_BF16_BITS = np.dtype("V2")     # how numpy holds a bfloat16 element


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dict path, leaf) pairs in sorted key order, as
    ``jax.tree_util.tree_leaves_with_path`` names and orders them."""
    if not isinstance(tree, dict):
        return [(prefix or "root", tree)]
    out = []
    for key in sorted(tree):
        out += _flatten(tree[key], f"{prefix}/{key}" if prefix else str(key))
    return out


def _rebuild(tree_like: Any, leaves: Dict[str, Any],
             prefix: str = "") -> Any:
    """``tree_like``'s nesting, each leaf taken from ``leaves`` by its
    path name."""
    if not isinstance(tree_like, dict):
        return leaves[prefix or "root"]
    return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree_like.items()}


def _is_dtensor(leaf: Any) -> bool:
    if not (isinstance(leaf, torch.Tensor)
            and torch.distributed.is_available()):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _to_host(leaf: Any) -> np.ndarray:
    """A tensor's copy in host memory (never a view of a CPU tensor that
    an in-place update could change), a DTensor's global array gathered
    from every rank (a collective); anything else as a numpy array.
    bfloat16 becomes 2-byte ``V2`` elements, as the JAX store writes it."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_BITS)
        return host.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    """The manifest's dtype: ``"bfloat16"`` for ``V2`` elements."""
    return "bfloat16" if arr.dtype == _BF16_BITS else str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None,
                    shard_filter: Optional[Callable[[str], bool]] = None
                    ) -> str:
    """Write checkpoint atomically; returns the final path. Every leaf
    is brought to the host (a DTensor gathered, on every rank alike)
    before ``shard_filter`` decides whether it is written."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {},
                                "extra": extra or {}}
    for name, leaf in _flatten(tree):
        arr = _to_host(leaf)
        if shard_filter is not None and not shard_filter(name):
            continue
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {"file": fname, "shape": list(arr.shape),
                                    "dtype": _dtype_name(arr)}
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name,
                                           "manifest.json")):
                steps.append(int(name[len("step_"):]))
    return max(steps) if steps else None


def load_checkpoint(directory: str, tree_like: Any,
                    step: Optional[int] = None,
                    device: DeviceLike = None,
                    shardings: Any = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (a nested dict whose
    leaves may be anything, e.g. meta tensors). Returns (tree, step,
    extra).

    ``shardings``: an optional nested dict of the same structure whose
    leaves are ``None`` or ``(DeviceMesh, placements)``; such a leaf
    becomes a DTensor with those placements, its local shard on this
    rank's device of the mesh's type (the elastic resume: any mesh). Every
    other leaf is a tensor on ``device``."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    placed = dict(_flatten(shardings)) if shardings is not None else {}
    loaded: Dict[str, torch.Tensor] = {}
    for name, _ in _flatten(tree_like):
        info = manifest["leaves"].get(name)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        full = _from_numpy(np.load(os.path.join(path, info["file"])),
                           info["dtype"])
        sh = placed.get(name)
        if sh is not None:
            loaded[name] = _distribute(full, *sh)
        else:
            loaded[name] = full.to(dev)
    return _rebuild(tree_like, loaded), step, manifest.get("extra", {})


def _distribute(full: torch.Tensor, mesh: Any, placements: Any) -> Any:
    """``full`` (the same on every rank) as a DTensor on ``mesh``: each
    rank keeps its own shard, nothing is sent (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor
    if mesh.device_type == "cuda":
        full = full.to(torch.device("cuda", torch.cuda.current_device()))
    return distribute_tensor(full, mesh, list(placements), src_data_rank=None)


class CheckpointManager:
    """Retention + async writes."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        save_checkpoint(self.directory, step, _host_tree(tree), extra)
        self._gc()

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        host_tree = _host_tree(tree)  # sync device→host copy

        def _write() -> None:
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device: DeviceLike = None, shardings: Any = None):
        return load_checkpoint(self.directory, tree_like, step, device,
                               shardings)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = sorted(
            int(n[len("step_"):]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


def _host_tree(tree: Any) -> Any:
    """Every leaf in host memory, gathered in sorted-name order (the same
    on every rank: a DTensor's gather is a collective)."""
    return _rebuild(tree, {name: _to_host(leaf)
                           for name, leaf in _flatten(tree)})
