"""The one-card side of the sharded tier against the JAX package's: the
mesh planning rule (a verbatim copy in the port) and the read side of the
``sharded_array`` journal codec. Spill records the JAX package writes with
8 host devices (in a subprocess, as ``tests/test_shard.py`` does) read
back equal in the port, and each kind of corruption raises
``MissingError``. A wide group shards over two or more distinct places
and micro-batches on any other inventory."""

import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.fusion import plans as jplans
from repro_torch.core.exceptions import MissingError
from repro_torch.core.pst import Task
from repro_torch.core.results import decode_journal_value
from repro_torch.device import virtual_devices
from repro_torch.fusion import fusable
from repro_torch.fusion import plans as tplans
from repro_torch.fusion.handles import SHARDED_CODEC, ArrayResult
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MEMBERS = [1, 2, 3, 7, 8, 9, 63, 64, 65, 100, 511, 512, 513, 1000, 1024,
           1025, 2047, 4096, 4097, 5000, 9000]


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8, 16])
def test_plan_mesh_matches_jax(n_devices):
    """Over a sweep of group widths, slot counts and batch caps the port's
    ``plan_mesh`` plans what the JAX package's does, and no mesh below
    two devices."""
    for n in MEMBERS:
        for member_slots in (1, 2):
            for max_batch in (1, 64, 512):
                args = (n, n_devices * member_slots, member_slots)
                kw = dict(max_batch=max_batch, max_devices=n_devices)
                got = tplans.plan_mesh(*args, **kw)
                want = jplans.plan_mesh(*args, **kw)
                assert (got is None) == (want is None), (args, kw)
                if got is not None:
                    assert (got.n_shards, list(got.batches)) == (
                        want.n_shards, list(want.batches)), (args, kw)
                    assert sum(got.batches) == n
                if n_devices < 2:
                    assert got is None


@fusable()
def k_sq(x):
    return torch.as_tensor(x, dtype=torch.float32) ** 2


@pytest.mark.parametrize("devices,shards", [
    ([torch.device("cpu")], 0),
    ([torch.device("cuda", 0)], 0),
    (["dev0", "dev1", "dev2", "dev3"], 0),
    ([torch.device("cuda", 0), torch.device("cuda", 0)], 0),
    ([torch.device("cuda", 0), torch.device("cuda", 1)], 2),
    (virtual_devices("cpu", 4), 4)],
    ids=["cpu", "one-cuda", "placeholders", "one-cuda-twice", "two-cuda",
         "virtual-cpu"])
def test_wide_group_micro_batches_on_any_inventory(devices, shards,
                                                   monkeypatch):
    """A group far past the sharding threshold packs, under the JAX
    package's rule, into shard carriers over two or more distinct places
    (two CUDA devices, or lanes of one device) and into micro-batch
    carriers on every other inventory (one device, placeholder names, a
    device listed twice). Planning reads the inventory's types only: with
    every CUDA call made to raise, it still plans. Every member lands in
    exactly one carrier."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("planning touched CUDA")
    for name in ("is_available", "device_count", "current_stream",
                 "Stream", "Event", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    rts = TorchRTS(devices=devices)
    rts.start(ResourceDescription(slots=len(devices)))
    try:
        n = 4 * tplans.DEFAULT_SHARD_MIN_MEMBERS
        members = [Task(name=f"m{i}", executable=k_sq, kwargs={"x": float(i)})
                   for i in range(n)]
        out = []
        rts._pack_group(members, out, rts.free_slots())
        assert out and all(t.executable.startswith("fused://") for t in out)
        carried = [m.uid for t in out for m in rts._fused[t.uid].members]
        assert sorted(carried) == sorted(m.uid for m in members)
        assert [rts._fused[t.uid].mesh_shards for t in out] == \
            [shards] * len(out)
        if shards:
            assert all(t.name.startswith(f"shard[{shards}x1x")
                       and t.slots == shards for t in out)
            assert rts.fusion_stats["shard_carriers"] == len(out)
        else:
            assert all(t.name.startswith("fused[") for t in out)
            assert rts.fusion_stats["shard_carriers"] == 0
    finally:
        rts.stop()


# --------------------------------------------------------------------------- #
# Sharded spill records written by the JAX package
# --------------------------------------------------------------------------- #

# name: leading-axis rows of the arrays the subprocess below writes
ROWS = {"f32": 16, "i32": 8, "f32_3d": 32}
WRITE = """
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.fusion.handles import ArrayResult

mesh = Mesh(np.array(jax.devices(), dtype=object), ("m",))
rng = np.random.default_rng(0)
values = {"f32": np.arange(64, dtype=np.float32).reshape(16, 4),
          "i32": np.arange(8, dtype=np.int32) * 3,
          "f32_3d": rng.standard_normal((32, 2, 3)).astype(np.float32)}
out = {}
for name, value in values.items():
    arr = jax.device_put(value, NamedSharding(mesh, P("m")))
    rec = ArrayResult(arr).to_journal(sys.argv[1])
    out[name] = {"record": rec, "value": value.tolist(),
                 "dtype": str(value.dtype)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_spills(tmp_path_factory):
    """{name: (record, value)} written by the JAX package's ``ArrayResult``
    over arrays split across 8 host devices on their leading axis."""
    spill = str(tmp_path_factory.mktemp("spill"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", WRITE, spill],
                          capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: (v["record"], np.asarray(v["value"], dtype=v["dtype"]))
            for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_jax_sharded_spill_reads_back_equal(jax_spills, name):
    record, value = jax_spills[name]
    assert record["__codec__"] == SHARDED_CODEC
    assert len(record["shards"]) == 8
    assert [s["rows"] for s in record["shards"]] == [ROWS[name] // 8] * 8
    back = decode_journal_value(record)
    assert isinstance(back, ArrayResult)
    host = np.asarray(back)
    assert host.dtype == value.dtype
    np.testing.assert_array_equal(host, value)


def _corrupt(record, tmp_path, kind):
    """A copy of ``record`` whose shard files live in ``tmp_path``, with
    one fault of ``kind``."""
    rec = copy.deepcopy(record)
    for s in rec["shards"]:
        dst = os.path.join(tmp_path, os.path.basename(s["path"]))
        shutil.copyfile(s["path"], dst)
        s["path"] = dst
    victim = rec["shards"][3]
    if kind == "missing":
        os.remove(victim["path"])
    elif kind == "sha256":
        victim["sha256"] = "0" * 64
    elif kind == "bytes":
        with open(victim["path"], "r+b") as fh:
            fh.seek(-4, os.SEEK_END)
            fh.write(b"\x00\x01\x02\x03")
    elif kind == "rows":
        victim["rows"] += 1
    elif kind == "shape":
        rec["shape"] = [rec["shape"][0] + 1] + rec["shape"][1:]
    elif kind == "no_shards":
        rec["shards"] = []
    return rec


@pytest.mark.parametrize("kind", ["missing", "sha256", "bytes", "rows",
                                  "shape", "no_shards"])
def test_each_corruption_raises_missing_error(jax_spills, tmp_path, kind):
    record, _ = jax_spills["f32"]
    with pytest.raises(MissingError):
        decode_journal_value(_corrupt(record, str(tmp_path), kind))
    # the untouched record still reads
    assert np.asarray(decode_journal_value(record)).shape == (16, 4)
