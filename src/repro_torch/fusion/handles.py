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

Sharded outputs (the sharded tier): a carrier over a mesh of places
produces each output as a :class:`ShardedValue` — its rows split over the
places, an ordered list of ``(start_row, tensor)`` with each tensor on its
own place. The handles stay shard-aware: a per-member read slices ONE
place's shard (never gathering the stacked batch), and the journal spill
serializes per shard as ``{"__codec__": "sharded_array", "shards":
[{"sha256", "path", "rows"}, ...], "shape", "dtype"}``, each shard
content-addressed exactly like a fused spill. The records are the JAX
package's: either package reads what the other wrote, every shard
verified.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.exceptions import MissingError
from ..core.results import register_result_codec, register_result_spiller

CODEC = "fused_array"
SHARDED_CODEC = "sharded_array"


class ShardedValue:
    """A value split on its rows over the places of a mesh: an ordered list
    of ``(start_row, tensor)``, each tensor on its own place, the rows
    tiling ``[0, shape[0])`` in order. The sharded tier carries link
    outputs in this form, so an intermediate never leaves its place."""

    __slots__ = ("shards",)

    def __init__(self, shards: List[Tuple[int, torch.Tensor]]) -> None:
        self.shards = sorted(((int(s), t) for s, t in shards),
                             key=lambda p: p[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        rows = sum(int(t.shape[0]) for _, t in self.shards)
        return (rows,) + tuple(self.shards[0][1].shape[1:])

    @property
    def dtype(self):
        return self.shards[0][1].dtype

    @property
    def ndim(self) -> int:
        return self.shards[0][1].dim()

    def local(self, i: int) -> torch.Tensor:
        """The tensor of place ``i``."""
        return self.shards[i][1]

    def owner(self, row: int) -> int:
        """Index of the shard that holds ``row``."""
        for i, (start, t) in enumerate(self.shards):
            if start <= row < start + int(t.shape[0]):
                return i
        raise IndexError(f"row {row} outside {self.shape[0]} rows")

    def __getitem__(self, row: int) -> torch.Tensor:
        start, t = self.shards[self.owner(row)]
        return t[row - start]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<ShardedValue shape={self.shape} dtype={self.dtype} "
                f"shards={len(self.shards)}>")


def _axis0_shards(value: Any) -> Optional[List[Tuple[int, torch.Tensor]]]:
    """``[(start_row, tensor), ...]`` when ``value`` is split over two or
    more places on its leading axis with rows that tile it in order, else
    None: per-shard reads and spills never fall back to a full gather on a
    layout they don't understand, so anything else takes the dense path."""
    if not isinstance(value, ShardedValue) or len(value.shards) < 2:
        return None
    rows = 0
    for start, t in value.shards:
        if start != rows or t.dim() == 0:
            return None
        rows += int(t.shape[0])
    return list(value.shards)


def to_host(value: Any) -> np.ndarray:
    """Host numpy view of a tensor (any device), sharded value, handle or
    array-like; a sharded value is copied shard by shard."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, ShardedValue):
        return np.concatenate([to_host(t) for _, t in value.shards], axis=0)
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
        plain ``result_omitted`` flag and the producer re-runs on resume).

        A sharded value spills per shard: each place's block is copied,
        hashed and written on its own (no gather of the stacked batch), and
        the record carries the ordered shard list so replay can verify each
        block's sha256 before concatenating."""
        if not spill_dir:
            return None
        os.makedirs(spill_dir, exist_ok=True)
        shards = _axis0_shards(self.value)
        if shards is not None:
            records = []
            for _, data in shards:
                block = np.ascontiguousarray(to_host(data))
                digest, path = _write_spill(block, spill_dir)
                records.append({"sha256": digest, "path": path,
                                "rows": int(block.shape[0])})
            return {"__codec__": SHARDED_CODEC, "shards": records,
                    "shape": list(self.value.shape),
                    "dtype": str(block.dtype)}
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
    When the parent is a :class:`ShardedValue`, a read slices only the one
    shard that owns the member's row; the other places' blocks are never
    touched.
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
            shards = _axis0_shards(self._parent)
            if shards is not None:
                start, data = shards[self._parent.owner(self._index)]
                piece = data[self._index - start]
            else:
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


def _verify_load(path: Optional[str], sha256: Optional[str],
                 kind: str) -> np.ndarray:
    if not path or not os.path.exists(path):
        raise MissingError(f"{kind} spill missing: {path!r}")
    host = np.load(path)
    digest = hashlib.sha256(np.ascontiguousarray(host).tobytes()).hexdigest()
    if digest != sha256:
        raise MissingError(f"{kind} spill corrupted: {path!r} "
                           f"(content hash mismatch)")
    return host


def _decode(record: Dict[str, Any]) -> ArrayResult:
    return ArrayResult(_verify_load(record.get("path"), record.get("sha256"),
                                    "fused-array"))


def _decode_sharded(record: Dict[str, Any]) -> ArrayResult:
    """Rebuild a sharded spill: every per-shard sha256 must verify, and the
    shard row counts must tile the recorded global shape — any mismatch is
    the ``result_omitted`` contract (raise, producer re-runs on resume)."""
    shards = record.get("shards") or []
    if not shards:
        raise MissingError("sharded-array spill record has no shards")
    blocks = [_verify_load(s.get("path"), s.get("sha256"), "sharded-array")
              for s in shards]
    for block, s in zip(blocks, shards):
        if int(block.shape[0]) != int(s.get("rows", -1)):
            raise MissingError(
                f"sharded-array spill corrupted: {s.get('path')!r} "
                f"(shard row count mismatch)")
    host = np.concatenate(blocks, axis=0) if len(blocks) > 1 else blocks[0]
    if list(host.shape) != list(record.get("shape") or host.shape):
        raise MissingError("sharded-array spill corrupted: reassembled "
                           "shape does not match record")
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
register_result_codec(SHARDED_CODEC, _decode_sharded)
register_result_spiller(_spill_bare_array)
