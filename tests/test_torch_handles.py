"""Tensor-backed result handles, and their journal spill against the JAX
package's: the same float32 values must spill to the same bytes, path and
record in both packages."""

import json

import numpy as np
import pytest
import torch

from repro.fusion import handles as jhandles
from repro_torch.core.results import decode_journal_value, spill_journal_value
from repro_torch.fusion.handles import ArrayResult, LazySlice


def test_array_result_over_tensor():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    h = ArrayResult(t)
    assert h.value is t and h.shape == (2, 3) and len(h) == 2
    assert h.dtype == torch.float32
    host = np.asarray(h)
    assert host.dtype == np.float32 and np.array_equal(host, t.numpy())
    assert np.asarray(h) is host            # one cached host copy
    assert h.tolist() == t.tolist()


def test_lazy_slice_reads_one_row_and_trims():
    parent = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    s = LazySlice(parent, 1, trim=3)
    assert s.shape == (3,) and s.dtype == torch.float32
    assert s._value is None                 # nothing sliced until read
    assert s.value.tolist() == [4.0, 5.0, 6.0]
    assert s._parent is None                # a read slice pins only its row
    assert np.array_equal(np.asarray(s), [4.0, 5.0, 6.0])


@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_spill_matches_jax_package(tmp_path, shape):
    host = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    ref = jhandles.ArrayResult(host).to_journal(jdir)
    got = ArrayResult(torch.from_numpy(host)).to_journal(tdir)
    assert got["dtype"] == "float32"
    assert {k: v for k, v in got.items() if k != "path"} == \
        {k: v for k, v in ref.items() if k != "path"}
    assert got["path"].replace(tdir, jdir) == ref["path"]
    with open(got["path"], "rb") as a, open(ref["path"], "rb") as b:
        assert a.read() == b.read()
    json.dumps(got)                         # the record journals as JSON
    back = decode_journal_value(got)
    assert isinstance(back, ArrayResult)
    assert np.array_equal(np.asarray(back), host)


def test_bare_tensor_results_spill_through_the_codec(tmp_path):
    t = torch.linspace(0, 1, 5)
    record = spill_journal_value(t, str(tmp_path))
    assert record["__codec__"] == "fused_array"
    assert np.array_equal(np.asarray(decode_journal_value(record)), t.numpy())
    assert spill_journal_value({"plain": 1}, str(tmp_path)) is None
