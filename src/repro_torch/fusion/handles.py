"""Array-result handles: fused outputs that stay device-resident.

A fused dispatch produces one stacked output tensor; each member's result
is a row of it. Wrapping the row in :class:`ArrayResult` (instead of
converting to a Python list) keeps the value on the device between a
producer stage and its consumer stage — the consumer's kernel receives the
tensor (``handle.value``) without a host round-trip.

Journaling: JSON-encoding arrays onto DONE records would blow the 256 KiB
``result_omitted`` cap for anything real, so a handle journals as a *spill
record* — ``{"__codec__": "fused_array", "sha256", "path", "shape",
"dtype"}`` — with the bytes content-addressed under the journal's sidecar
directory. The record (``dtype`` is the numpy name, e.g. ``float32``) and
the spilled bytes are the same as the JAX package writes for the same
values. Replay decodes the record back into an :class:`ArrayResult` over a
host array (verifying the hash); a missing or corrupted spill raises, which
the resume path answers by re-running the producer.

The sharded spill format of the JAX package waits for the sharded tier.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.exceptions import MissingError
from ..core.results import register_result_codec, register_result_spiller

CODEC = "fused_array"


def to_host(value: Any) -> np.ndarray:
    """Host numpy view of a tensor (any device), handle or array-like."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _write_spill(host: np.ndarray, spill_dir: str) -> Tuple[str, str]:
    """Content-addressed ``.npy`` write; returns ``(sha256, path)``."""
    digest = hashlib.sha256(host.tobytes()).hexdigest()
    path = os.path.join(spill_dir, f"{digest[:32]}.npy")
    if not os.path.exists(path):
        # content-addressed: concurrent writers of the same value are
        # idempotent; write-then-rename keeps replay from reading a torn
        # file after a crash mid-spill (the tmp name must end in .npy —
        # np.save appends the suffix to anything else)
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        np.save(tmp, host)
        os.replace(tmp, path)
    return digest, path


class ArrayResult:
    """A device-resident tensor produced by a fused (or scalar) dispatch.

    Ergonomics: ``np.asarray(handle)`` yields the host array (one cached
    ``.cpu().numpy()`` copy — N consumers of one handle cost one device
    transfer); ``.value`` is the wrapped tensor itself; ``len`` /
    ``.shape`` / ``.dtype`` forward.
    """

    __slots__ = ("_value", "_host")

    def __init__(self, value: Any) -> None:
        self._value = value
        self._host = None

    @property
    def value(self) -> Any:
        return self._value

    @property
    def shape(self):
        return tuple(getattr(self.value, "shape", ()))

    @property
    def dtype(self):
        return getattr(self.value, "dtype", None)

    def __len__(self) -> int:
        return int(self.shape[0]) if self.shape else 0

    def __array__(self, dtype=None, copy=None):
        if self._host is None:
            self._host = to_host(self.value)
        return self._host.astype(dtype) if dtype is not None else self._host

    def tolist(self):
        return self.__array__().tolist()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<ArrayResult shape={tuple(self.shape)} dtype={self.dtype}>"

    # -- journal spill ------------------------------------------------------ #

    def to_journal(self, spill_dir: Optional[str]) -> Optional[Dict[str, Any]]:
        """Spill the bytes and return the journalable record (or ``None``
        when no sidecar directory exists — the caller then journals the
        plain ``result_omitted`` flag and the producer re-runs on resume)."""
        if not spill_dir:
            return None
        os.makedirs(spill_dir, exist_ok=True)
        host = np.ascontiguousarray(self.__array__())
        digest, path = _write_spill(host, spill_dir)
        return {"__codec__": CODEC, "sha256": digest, "path": path,
                "shape": list(host.shape), "dtype": str(host.dtype)}


class LazySlice(ArrayResult):
    """A member's row of a stacked fused output, sliced only when read.

    Fan-out delivers one handle per member without touching the device;
    the row (trimmed to the member's unpadded length) is taken the first
    time a consumer asks for it. The parent tensor stays alive for as long
    as an unread member handle does; a read handle pins only its own row.
    """

    __slots__ = ("_parent", "_index", "_trim")

    def __init__(self, parent: Any, index: int,
                 trim: Optional[int] = None) -> None:
        super().__init__(None)
        self._parent = parent
        self._index = index
        self._trim = trim

    @property
    def value(self) -> Any:
        if self._value is None:
            piece = self._parent[self._index]
            if self._trim is not None:
                piece = piece[:self._trim]
            self._value = piece
            # drop the parent: a materialized slice must pin only its own
            # row — one retained member handle must not keep the whole
            # stacked micro-batch alive
            self._parent = None
        return self._value

    @property
    def shape(self):
        if self._value is not None:
            return tuple(getattr(self._value, "shape", ()))
        shape = tuple(getattr(self._parent, "shape", ()))[1:]
        if self._trim is not None and shape:
            shape = (self._trim,) + shape[1:]
        return shape

    @property
    def dtype(self):
        if self._value is not None:
            return getattr(self._value, "dtype", None)
        return getattr(self._parent, "dtype", None)


def _decode(record: Dict[str, Any]) -> ArrayResult:
    path, sha256 = record.get("path"), record.get("sha256")
    if not path or not os.path.exists(path):
        raise MissingError(f"fused-array spill missing: {path!r}")
    host = np.load(path)
    digest = hashlib.sha256(np.ascontiguousarray(host).tobytes()).hexdigest()
    if digest != sha256:
        raise MissingError(f"fused-array spill corrupted: {path!r} "
                           f"(content hash mismatch)")
    return ArrayResult(host)


def _spill_bare_array(value: Any, spill_dir: str) -> Optional[Dict[str, Any]]:
    """Journal spiller for BARE array results: a fused kernel executed on
    the scalar path (fuse=False, below-threshold group, LocalRTS) returns
    a raw tensor or numpy array that cannot JSON — spill it through the
    same content-addressed codec so resume restores it instead of
    re-running the producer."""
    if isinstance(value, (torch.Tensor, np.ndarray, np.generic)):
        return ArrayResult(value).to_journal(spill_dir)
    return None


register_result_codec(CODEC, _decode)
register_result_spiller(_spill_bare_array)
