"""Atomic, async-capable checkpoint store in the JAX package's layout.

A checkpoint written by either package restores in the other:

* **Atomicity** — a checkpoint is written to ``step_<n>.tmp/`` and renamed
  to ``step_<n>/`` only after every leaf and the manifest are on disk; a
  crash mid-write never corrupts the latest valid checkpoint.
* **Layout** — ``step_%08d/manifest.json`` holds ``step``, ``leaves``
  (file, shape and dtype of each) and ``extra``; each leaf of the nested
  dict is its own ``.npy``, named by its dict path with ``/`` → ``__``
  (``params/blocks/attn/wq`` → ``params__blocks__attn__wq.npy``).
* **Async** — ``CheckpointManager.save_async`` copies every leaf to host
  memory synchronously (device→host, so a later in-place update cannot
  reach the snapshot) and writes to disk on a background thread.
* **Retention** — keep the newest ``keep`` checkpoints.

``restore`` places the leaves on the device it is given. The sharded
per-host layout of the JAX store (``shard_filter``, re-sharding on
restore) waits for the sharded tier (ROADMAP.md A10).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dict path, leaf) pairs in sorted key order, as
    ``jax.tree_util.tree_leaves_with_path`` names and orders them."""
    if not isinstance(tree, dict):
        return [(prefix or "root", tree)]
    out = []
    for key in sorted(tree):
        out += _flatten(tree[key], f"{prefix}/{key}" if prefix else str(key))
    return out


def _to_host(leaf: Any) -> np.ndarray:
    """A tensor's copy in host memory (never a view of a CPU tensor that
    an in-place update could change); anything else as a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write checkpoint atomically; returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {},
                                "extra": extra or {}}
    for name, leaf in _flatten(tree):
        arr = _to_host(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
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
                    device: DeviceLike = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (a nested dict whose
    leaves may be anything, e.g. meta tensors), each leaf a tensor on
    ``device``. Returns (tree, step, extra)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    loaded: Dict[str, torch.Tensor] = {}
    for name, _ in _flatten(tree_like):
        info = manifest["leaves"].get(name)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.load(os.path.join(path, info["file"]))
        loaded[name] = torch.from_numpy(arr).to(dev)

    def rebuild(tree, prefix=""):
        if not isinstance(tree, dict):
            return loaded[prefix or "root"]
        return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return rebuild(tree_like), step, manifest.get("extra", {})


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
                device: DeviceLike = None):
        return load_checkpoint(self.directory, tree_like, step, device)

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
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return _to_host(tree)
