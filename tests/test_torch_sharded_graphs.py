"""The sharded tier's link graphs, on the CPU: the graph key a link call
gets (``fusion/engine.py::_graph_key``), and the graph counters of
``fusion_stats``, which stay 0 on CPU places: lanes of the CPU are never
graphed, so the tier runs there as before. The capture, the replay and
the refusal of a host sync run on the card (``tests/test_torch_gpu.py``)."""

import pytest
import torch

from repro_torch import api
from repro_torch.device import virtual_devices
from repro_torch.fusion import engine as fengine
from repro_torch.fusion import fusable, fusable_reduction
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS


def _link(x, y, scale=1.0):
    return x * scale + y


def _kw(n=4, dtype=torch.float32):
    return {"x": torch.zeros(n, 3, dtype=dtype)}, {"y": torch.ones(3)}


def test_equal_calls_share_a_key():
    a = fengine._graph_key(_link, {"scale": 2.0}, *_kw())
    b = fengine._graph_key(_link, {"scale": 2.0}, *_kw())
    assert a is not None and a == b and hash(a) == hash(b)


@pytest.mark.parametrize("change", ["shape", "dtype", "statics", "kernel",
                                    "value", "structure"])
def test_a_change_of_what_the_graph_bakes_in_changes_the_key(change):
    base = fengine._graph_key(_link, {"scale": 2.0}, *_kw())
    fn, statics, (kw, shared) = _link, {"scale": 2.0}, _kw()
    if change == "shape":
        kw, shared = _kw(n=8)
    elif change == "dtype":
        kw, shared = _kw(dtype=torch.float64)
    elif change == "statics":
        statics = {"scale": 3.0}
    elif change == "kernel":
        fn = lambda x, y, scale=1.0: x - y      # noqa: E731
    elif change == "value":                     # a non-tensor leaf
        shared = {"y": 1.5}
    else:
        kw = {"x": kw["x"], "z": torch.zeros(4)}
    assert fengine._graph_key(fn, statics, kw, shared) != base


def test_an_unhashable_static_gives_no_key():
    assert fengine._graph_key(_link, {"scale": [2.0]}, *_kw()) is None


@fusable()
def k_affine(x):
    x = torch.as_tensor(x, dtype=torch.float32)
    return 2 * x + 1


@fusable_reduction(kind="sum")
def r_sum(values):
    raise RuntimeError("the scalar body must not run")


def test_cpu_lanes_are_never_graphed():
    fengine.release_graphs()
    ens = api.ensemble(k_affine, over=[{"x": float(i)} for i in range(16)],
                       name="aff")
    obj = api.gather(ens, r_sum, name="aff-sum")
    holder = {}

    def factory():
        holder["rts"] = TorchRTS(devices=virtual_devices("cpu", 4),
                                 shard_min_members=8)
        return holder["rts"]

    res = api.run(obj, resources=ResourceDescription(slots=4),
                  rts_factory=factory, timeout=60)
    assert res.all_done
    stats = holder["rts"].fusion_stats
    total = float(obj.out.result())
    res.close()
    assert stats["shard_carriers"] == 1
    assert {k: stats[k] for k in fengine.GRAPH_STATS} == \
        dict.fromkeys(fengine.GRAPH_STATS, 0)
    assert not fengine._graph_stores
    assert total == float(sum(2 * i + 1 for i in range(16)))
