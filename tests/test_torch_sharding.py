"""The port's sharding rules (``repro_torch.models.sharding``) held to the
JAX package's (``repro.models.sharding``): every spec equal, leaf for
leaf, for all 10 architectures on the stub meshes of the JAX tests
((16, 16), (2, 16, 16), (1, 1)) and on the port's H100 meshes ((32, 8),
(2, 32, 8)), and the eight cases of ``tests/test_sharding.py`` on the
port."""

from types import SimpleNamespace

import jax
import pytest
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.models import sharding as jshd
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import get_config as jget_config
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.config import SHAPES, get_config, list_archs


def _stub(shape_dict):
    return SimpleNamespace(shape=shape_dict,
                           axis_names=tuple(shape_dict.keys()))


POD = Mesh(("data", "model"), (16, 16))
MULTI = Mesh(("pod", "data", "model"), (2, 16, 16))
SINGLE = Mesh(("data", "model"), (1, 1))
H100 = make_production_mesh()
H100_MULTI = make_production_mesh(multi_pod=True)
MESHES = {"16x16": POD, "2x16x16": MULTI, "1x1": SINGLE,
          "h100_32x8": H100, "h100_2x32x8": H100_MULTI}


def _jax_flat(tree):
    """{path: tuple(spec)} of a JAX PartitionSpec pytree."""
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", k) for k in path): tuple(spec)
            for path, spec in flat}


def _port_flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _jmesh(mesh):
    return _stub(mesh.shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_jax_leaf_for_leaf(arch, mesh_name):
    mesh = MESHES[mesh_name]
    jm = _jmesh(mesh)
    jcfg = jget_config(arch)
    cfg = get_config(arch)
    assert shd.kv_repeat_for(cfg, mesh) == jshd.kv_repeat_for(jcfg, jm)
    kv = shd.kv_repeat_for(cfg, mesh)
    jcfg, cfg = jcfg.replace(kv_repeat=kv), cfg.replace(kv_repeat=kv)
    jstate = _jax_flat(jshd.train_state_specs(jcfg, jm))
    state = _port_flat(shd.train_state_specs(cfg, mesh))
    assert set(state) == set(jstate)
    for path, spec in state.items():
        assert isinstance(spec, shd.PSpec)
        assert tuple(spec) == jstate[path], (path, spec, jstate[path])
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert shd.batch_pspecs(cfg, shape, mesh) == {
            k: tuple(v) for k, v in
            jshd.batch_pspecs(jcfg, jshape, jm).items()}
        assert tuple(shd.token_pspec(cfg, shape, mesh)) == tuple(
            jshd.token_pspec(jcfg, jshape, jm))
        if shape.kind == "decode":
            cache = _port_flat(shd.cache_pspecs(cfg, shape, mesh))
            jcache = _jax_flat(jshd.cache_pspecs(jcfg, jshape, jm))
            assert cache == jcache, (name, cache, jcache)
    assert shd.dp_axes(mesh) == jshd.dp_axes(jm)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_follow_the_spec(mesh_name):
    mesh = MESHES[mesh_name]
    cfg = get_config("dbrx-132b")
    specs = shd.param_specs(cfg, mesh)
    placements = shd.named(mesh, specs)
    for path, spec in _port_flat(specs).items():
        pl = _port_flat(placements)[path]
        assert len(pl) == len(mesh.axis_names)
        for name, p in zip(mesh.axis_names, pl):
            dims = [i for i, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            assert p == (Shard(dims[0]) if dims else Replicate())
    assert shd.to_placements(shd.PSpec(("pod", "data"), None, "model"),
                             H100_MULTI) == (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError):
        shd.to_placements(shd.PSpec("data", "data"), H100)


# --------------------------------------------------------------------------- #
# The JAX test suite's eight cases, on the port's rules
# --------------------------------------------------------------------------- #

def _leaves_with_specs(cfg, mesh):
    tree = _port_flat(transformer.abstract_params(cfg))
    specs = _port_flat(shd.param_specs(cfg, mesh))
    assert set(tree) == set(specs)
    return [(p, tree[p], specs[p]) for p in tree]


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "h100_32x8",
                                       "h100_2x32x8"])
def test_every_sharded_dim_is_divisible_all_archs(mesh_name):
    mesh = MESHES[mesh_name]
    for arch in list_archs():
        cfg = get_config(arch)
        for path, leaf, spec in _leaves_with_specs(cfg, mesh):
            assert len(spec) <= len(leaf.shape), (arch, path)
            for dim, ax in zip(leaf.shape, spec):
                if ax is None:
                    continue
                size = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    size *= mesh.shape[a]
                assert dim % size == 0, (arch, path, dim, ax)


def test_single_device_mesh_all_replicated():
    for _, _, spec in _leaves_with_specs(get_config("stablelm-12b"),
                                         SINGLE):
        assert all(ax is None for ax in spec)


@pytest.mark.parametrize("mesh", [POD, H100], ids=["16x16", "h100_32x8"])
def test_attention_replicated_when_heads_indivisible(mesh):
    # qwen2-vl-2b: 12 heads, neither 16 nor 8 divides them
    for path, leaf, spec in _leaves_with_specs(get_config("qwen2-vl-2b"),
                                               mesh):
        if "attn" in path and path[-1] == "wq":
            assert spec[-1] is None


@pytest.mark.parametrize("mesh", [POD, H100], ids=["16x16", "h100_32x8"])
def test_experts_sharded_on_model(mesh):
    found = False
    for path, leaf, spec in _leaves_with_specs(get_config("dbrx-132b"),
                                               mesh):
        if "moe" in path and path[-1] == "wg" and "shared" not in path:
            assert spec[1] == "model"  # expert dim
            found = True
    assert found


def test_kv_repeat_selection():
    assert shd.kv_repeat_for(get_config("dbrx-132b"), POD) == 2    # 8→16
    assert shd.kv_repeat_for(get_config("chatglm3-6b"), POD) == 8  # 2→16
    assert shd.kv_repeat_for(get_config("zamba2-7b"), POD) == 1
    assert shd.kv_repeat_for(get_config("qwen2-vl-2b"), POD) == 1
    assert shd.kv_repeat_for(get_config("stablelm-12b"), SINGLE) == 1
    # on the H100 mesh's 8-way model axis
    assert shd.kv_repeat_for(get_config("dbrx-132b"), H100) == 1
    assert shd.kv_repeat_for(get_config("chatglm3-6b"), H100) == 4


def test_batch_specs_shard_batch_when_divisible():
    cfg = get_config("stablelm-12b")
    assert shd.batch_pspecs(cfg, SHAPES["train_4k"], POD)["inputs"][0] \
        == "data"
    assert shd.batch_pspecs(cfg, SHAPES["train_4k"], H100_MULTI)[
        "inputs"][0] == ("pod", "data")
    assert shd.token_pspec(cfg, SHAPES["long_500k"], POD)[0] is None


@pytest.mark.parametrize("mesh", [POD, H100], ids=["16x16", "h100_32x8"])
def test_cache_specs_seq_sharded_for_batch1(mesh):
    cfg = get_config("zamba2-7b")
    cfg = cfg.replace(kv_repeat=shd.kv_repeat_for(cfg, mesh))
    k = shd.cache_pspecs(cfg, SHAPES["long_500k"], mesh)["k"]
    assert k[1] is None and k[2] == "data" and k[3] == "model"
    k2 = shd.cache_pspecs(cfg, SHAPES["decode_32k"], mesh)["k"]
    assert k2[1] == "data" and k2[2] is None


def test_opt_state_specs_mirror_params():
    ts = shd.train_state_specs(get_config("minitron-4b"), POD)
    assert _port_flat(ts["params"]) == _port_flat(ts["opt"]["m"])
    assert ts["opt"]["step"] == shd.PSpec() == ()


@pytest.mark.parametrize("n,tp,expect", [(256, 8, (32, 8)), (12, 8, (2, 6)),
                                         (7, 8, (1, 7)), (5, 2, (5, 1)),
                                         (1, 8, (1, 1))])
def test_make_mesh_for_clamps_tp_to_a_divisor(n, tp, expect):
    """JAX's elastic re-mesh rule: the TP degree drops to the largest
    divisor of the device count not above it (a count or a device list)."""
    from repro_torch.launch.mesh import make_mesh_for
    for arg in (n, list(range(n))):
        mesh = make_mesh_for(arg, tp)
        assert mesh.sizes == expect and mesh.axis_names == ("data", "model")
        assert mesh.size == n and mesh.device_mesh is None
    assert make_production_mesh().shape == {"data": 32, "model": 8}
    assert make_production_mesh(multi_pod=True).size == 512
