"""The port's dry-run inputs held to the JAX package's: ``cells()``, the
meta-tensor ``input_specs`` of every cell and ``abstract_params`` of every
architecture have the shapes and dtypes of JAX's ``ShapeDtypeStruct``s,
leaf for leaf."""

import jax
import numpy as np
import pytest
import torch

from repro.models import input_specs as jispec
from repro.models import transformer as jtransformer
from repro.models.config import cells as jcells
from repro.models.config import get_config as jget_config
from repro_torch.models import input_specs as ispec
from repro_torch.models import transformer
from repro_torch.models.config import SHAPES, cells, get_config, list_archs

_DT = {np.dtype("float32"): torch.float32, np.dtype("int32"): torch.int32,
       "bfloat16": torch.bfloat16}


def _dtype(d):
    d = np.dtype(d)
    return _DT.get(d, _DT.get(d.name))


def _jax_flat(tree):
    return {tuple(getattr(k, "key", k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _assert_same(port, jx):
    p, j = _port_flat(port), _jax_flat(jx)
    assert set(p) == set(j)
    for path, leaf in p.items():
        if path[-1] == "length":     # the port's cache length is an int
            assert leaf == 0 and j[path].shape == ()
            continue
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(j[path].shape), path
        assert leaf.dtype == _dtype(j[path].dtype), path


def test_cells_equal_jax():
    for inc in (False, True):
        ours = [(a, s.name, s.seq_len, s.global_batch, s.kind, skip is None)
                for a, s, skip in cells(include_skipped=inc)]
        theirs = [(a, s.name, s.seq_len, s.global_batch, s.kind,
                   skip is None) for a, s, skip in jcells(
                       include_skipped=inc)]
        assert ours == theirs
    assert len(list(cells(include_skipped=True))) == 40
    skipped = [a for a, s, skip in cells(include_skipped=True) if skip]
    assert len(skipped) == 8 and "zamba2-7b" not in skipped


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_equal_jax(arch):
    _assert_same(transformer.abstract_params(get_config(arch)),
                 jtransformer.abstract_params(jget_config(arch)))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if shape == "decode_32k":     # a mesh's KV replication
        cfg, jcfg = cfg.replace(kv_repeat=2), jcfg.replace(kv_repeat=2)
    from repro.models.config import SHAPES as JSHAPES
    _assert_same(ispec.input_specs(cfg, SHAPES[shape]),
                 jispec.input_specs(jcfg, JSHAPES[shape]))


def test_meta_cache_allocates_nothing():
    cfg = get_config("zamba2-7b")
    cache = transformer.init_cache(cfg, 1, 524288, device="meta")
    assert cache["length"] == 0
    assert all(t.device.type == "meta" for p, t in
               _port_flat(cache).items() if p[-1] != "length")
