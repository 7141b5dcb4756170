"""The write side of the ``sharded_array`` journal codec and the shard-aware
handles. An output split over 8 lanes of the CPU spills per shard; the
records read back equal here, the JAX package's ``decode_journal_value``
reads them (a subprocess on 8 forced host devices), and its own spills of
the same values carry the same shard hashes and row counts. A member's
lazy read touches only its shard; an ``ArrayResult``'s host view gathers
once."""

import copy
import os

import numpy as np
import pytest
import torch

from _torch_sharded import run_jax
from repro_torch.core.exceptions import MissingError
from repro_torch.core.results import decode_journal_value
from repro_torch.fusion.handles import (SHARDED_CODEC, ArrayResult,
                                        LazySlice, ShardedValue,
                                        _axis0_shards)

VALUES = {
    "f32": np.arange(64, dtype=np.float32).reshape(16, 4),
    "i32": np.arange(8, dtype=np.int32) * 3,
    "f32_3d": np.random.default_rng(0).standard_normal(
        (32, 2, 3)).astype(np.float32)}

JAX_SOURCE = """
import json
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core.results import decode_journal_value
from repro.fusion.handles import ArrayResult

records = json.loads(__RECORDS__)
mesh = Mesh(np.array(jax.devices(), dtype=object), ("m",))
out = {"read": {}, "written": {}}
for name, rec in records.items():
    out["read"][name] = np.asarray(decode_journal_value(rec)).tolist()
    value = np.asarray(out["read"][name], dtype=rec["dtype"])
    arr = jax.device_put(value, NamedSharding(mesh, P("m")))
    out["written"][name] = ArrayResult(arr).to_journal(__SPILL__)
print(json.dumps(out))
"""


def sharded(value: np.ndarray, n: int = 8) -> ShardedValue:
    rows = value.shape[0] // n
    return ShardedValue([(i * rows, torch.from_numpy(
        value[i * rows:(i + 1) * rows].copy())) for i in range(n)])


@pytest.fixture(scope="module")
def spills(tmp_path_factory):
    """The port's records for VALUES, and what the JAX package read back
    from them and wrote for the same values."""
    import json
    ours = str(tmp_path_factory.mktemp("port"))
    theirs = str(tmp_path_factory.mktemp("jax"))
    records = {name: ArrayResult(sharded(v)).to_journal(ours)
               for name, v in VALUES.items()}
    out = run_jax(JAX_SOURCE.replace("__RECORDS__",
                                     repr(json.dumps(records)))
                  .replace("__SPILL__", repr(theirs)))
    return records, out


@pytest.mark.parametrize("name", sorted(VALUES))
def test_port_spill_is_per_shard_and_round_trips(spills, name):
    records, _ = spills
    rec = records[name]
    value = VALUES[name]
    assert rec["__codec__"] == SHARDED_CODEC
    assert rec["shape"] == list(value.shape)
    assert rec["dtype"] == str(value.dtype)
    assert [s["rows"] for s in rec["shards"]] == [value.shape[0] // 8] * 8
    assert len({s["path"] for s in rec["shards"]}) == 8
    back = decode_journal_value(rec)
    assert isinstance(back, ArrayResult)
    host = np.asarray(back)
    assert host.dtype == value.dtype
    np.testing.assert_array_equal(host, value)


@pytest.mark.parametrize("name", sorted(VALUES))
def test_jax_reads_port_spill(spills, name):
    _, out = spills
    np.testing.assert_array_equal(
        np.asarray(out["read"][name], dtype=VALUES[name].dtype), VALUES[name])


@pytest.mark.parametrize("name", sorted(VALUES))
def test_port_spill_equals_jax_spill(spills, name):
    """The JAX package's per-shard spill of the same values: the same
    codec, shape, dtype, shard row counts and content hashes."""
    records, out = spills
    ours, theirs = records[name], out["written"][name]
    for key in ("__codec__", "shape", "dtype"):
        assert ours[key] == theirs[key]
    assert [(s["sha256"], s["rows"]) for s in ours["shards"]] == \
        [(s["sha256"], s["rows"]) for s in theirs["shards"]]


@pytest.mark.parametrize("kind", ["sha256", "bytes", "missing"])
def test_corrupt_port_shard_raises(spills, tmp_path, kind):
    records, _ = spills
    rec = copy.deepcopy(records["f32"])
    victim = rec["shards"][5]
    dst = os.path.join(tmp_path, "victim.npy")
    with open(victim["path"], "rb") as src, open(dst, "wb") as fh:
        fh.write(src.read())
    victim["path"] = dst
    if kind == "sha256":
        victim["sha256"] = "0" * 64
    elif kind == "bytes":
        with open(dst, "r+b") as fh:
            fh.seek(-4, os.SEEK_END)
            fh.write(b"\x00\x01\x02\x03")
    else:
        os.remove(dst)
    with pytest.raises(MissingError):
        decode_journal_value(rec)


def test_lazy_slice_reads_only_its_shard(monkeypatch):
    sv = sharded(VALUES["f32_3d"])
    def no_gather(*args, **kwargs):
        raise AssertionError("a member read gathered the batch")
    monkeypatch.setattr(torch, "cat", no_gather)
    s = LazySlice(sv, 13, trim=1)
    v = s.value
    shard = sv.local(sv.owner(13))
    assert sv.owner(13) == 3
    assert v.untyped_storage().data_ptr() == \
        shard.untyped_storage().data_ptr()
    assert s.value is v and s._parent is None
    np.testing.assert_array_equal(np.asarray(s), VALUES["f32_3d"][13][:1])
    assert tuple(LazySlice(sv, 2).shape) == (2, 3)


def test_array_result_host_view_gathers_once(monkeypatch):
    from repro_torch.fusion import handles
    sv = sharded(VALUES["f32"])
    calls = []
    real = handles.to_host
    monkeypatch.setattr(handles, "to_host",
                        lambda v: calls.append(v) or real(v))
    h = ArrayResult(sv)
    first = np.asarray(h)
    assert np.asarray(h) is first
    # one gather: the sharded value once, then each of its 8 shards once
    assert sum(c is sv for c in calls) == 1 and len(calls) == 9
    np.testing.assert_array_equal(first, VALUES["f32"])
    assert h.shape == (16, 4) and len(h) == 16


def test_axis0_shards_only_for_clean_splits():
    sv = sharded(VALUES["f32"])
    assert [s for s, _ in _axis0_shards(sv)] == list(range(0, 16, 2))
    assert _axis0_shards(ShardedValue([(0, torch.zeros(4, 2))])) is None
    gap = ShardedValue([(0, torch.zeros(2)), (3, torch.zeros(2))])
    assert _axis0_shards(gap) is None
    assert _axis0_shards(torch.zeros(4, 2)) is None
    one = ArrayResult(ShardedValue([(0, torch.ones(3, 2))]))
    assert one.to_journal(None) is None
