"""The checkpoint store's sharded layout, across both packages.

* ``shard_filter`` writes the same manifest and leaves as the JAX store's
  on the same tree, and a refused leaf is missing on load in both;
* a train state of DTensors, saved by a gloo group of 2 ranks on a (1, 2)
  mesh (each rank its own leaves through ``shard_filter``, and the whole
  state through ``save_async``), restores in JAX onto ``NamedSharding``\\ s
  of a (4, 2) mesh of 8 forced host devices bit for bit;
* a train state (its parameters in bf16) that JAX saved from that 8-device
  mesh restores in the port onto gloo meshes of 2 ranks (2, 1) and of 4
  ranks (2, 2) with ``named(mesh, train_state_specs(cfg, mesh))``: each
  rank's local shard is the matching slice of JAX's array, bit for bit;
  the 4 ranks also restore the port's own 2-rank checkpoint (an elastic
  resume in the port).

The ranks are ``tests/_torch_ckpt_ranks.py`` processes; the JAX side runs
in a subprocess, as ``tests/_torch_sharded.py`` runs it. The two rounds of
processes each run at once.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ckpt_ranks as ranks
from _torch_sharded import run_jax
from repro.checkpoint import store as jstore
from repro_torch.checkpoint import load_checkpoint, save_checkpoint

JAX_STEP = 11
JAX_MESH = (4, 2)

JAX_SAVE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import store
from repro.models import sharding, steps
from repro.models.config import get_config
cfg = get_config({arch!r}, smoke=True)
mesh = Mesh(np.array(jax.devices()).reshape{mesh}, ("data", "model"))
state = jax.jit(lambda k: steps.init_train_state(cfg, k))(
    jax.random.PRNGKey(3))
keys = iter(jax.random.split(jax.random.PRNGKey(4), 64))
state["params"] = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                               state["params"])
state["opt"]["m"] = jax.tree.map(
    lambda a: jax.random.normal(next(keys), a.shape), state["opt"]["m"])
state["opt"]["v"] = jax.tree.map(
    lambda a: jax.random.uniform(next(keys), a.shape), state["opt"]["v"])
state["opt"]["step"] = jnp.asarray({step}, jnp.int32)
state = jax.device_put(state, sharding.named(
    mesh, sharding.train_state_specs(cfg, mesh)))
sharded = sum(not a.sharding.is_fully_replicated
              for a in jax.tree.leaves(state))
store.save_checkpoint({out!r}, {step}, state, extra={{"loss": 2.5}})
print(json.dumps({{"sharded": sharded, "devices": len(jax.devices())}}))
"""

JAX_RESTORE = """
import json, os
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.checkpoint import store
from repro.models import sharding, steps
from repro.models.config import get_config
cfg = get_config({arch!r}, smoke=True)
mesh = Mesh(np.array(jax.devices()).reshape{mesh}, ("data", "model"))
specs = sharding.train_state_specs(cfg, mesh)


def prune(tree, keep, prefix=""):
    out = {{}}
    for k, v in tree.items():
        name = f"{{prefix}}{{k}}"
        if isinstance(v, dict):
            sub = prune(v, keep, name + "/")
            if sub:
                out[k] = sub
        elif name in keep:
            out[k] = v
    return out


def paths(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from paths(tree[k], f"{{prefix}}{{k}}/")
        else:
            yield f"{{prefix}}{{k}}", tree[k]


arrays, seen = {{}}, {{}}
for sub in {subs!r}:
    d = os.path.join({src!r}, sub)
    with open(os.path.join(d, "step_{step:08d}", "manifest.json")) as fh:
        keep = set(json.load(fh)["leaves"])
    like = prune(steps.abstract_train_state(cfg), keep)
    want = prune(specs, keep)
    tree, step, extra = store.load_checkpoint(
        d, like, shardings=sharding.named(mesh, want))
    wanted = dict(paths(want))
    sharded = 0
    for name, leaf in paths(tree):
        assert leaf.sharding == NamedSharding(mesh, wanted[name]), name
        full = np.asarray(leaf)
        for shard in leaf.addressable_shards:
            assert np.array_equal(np.asarray(shard.data), full[shard.index])
        sharded += not leaf.sharding.is_fully_replicated
        arrays[f"{{sub}}:{{name}}"] = full
    seen[sub] = {{"step": step, "extra": extra, "names": sorted(keep),
                 "sharded": sharded}}
np.savez({npz!r}, **arrays)
print(json.dumps(seen))
"""


def _jax_bits(path: str, info: dict) -> np.ndarray:
    """A leaf the JAX store wrote, bf16 as its int16 bits."""
    arr = np.load(os.path.join(path, info["file"]))
    return arr.view(np.int16) if info["dtype"] == "bfloat16" else arr


def _tree():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float32),
                       "emb": rng.standard_normal((5, 2)).astype(np.float32)},
            "opt": {"step": np.asarray(3, np.int32)}}


def test_shard_filter_gives_the_jax_stores_manifest(tmp_path):
    keep = {"params/w", "opt/step"}
    tree = _tree()
    as_torch = {"params": {k: torch.from_numpy(v)
                           for k, v in tree["params"].items()},
                "opt": {"step": torch.from_numpy(tree["opt"]["step"])}}
    as_torch["params"]["emb"] = as_torch["params"]["emb"].bfloat16()
    as_jax = dict(tree, params=dict(
        tree["params"], emb=jnp.asarray(tree["params"]["emb"], jnp.bfloat16)))
    for emb_kept in (False, True):
        names = keep | ({"params/emb"} if emb_kept else set())
        jdir, tdir = str(tmp_path / f"jax{emb_kept}"), str(
            tmp_path / f"port{emb_kept}")
        jpath = jstore.save_checkpoint(jdir, 2, as_jax, {"a": 1},
                                       shard_filter=names.__contains__)
        tpath = save_checkpoint(tdir, 2, as_torch, {"a": 1},
                                shard_filter=names.__contains__)
        manifests = [json.load(open(os.path.join(p, "manifest.json")))
                     for p in (jpath, tpath)]
        assert manifests[0] == manifests[1]
        assert sorted(manifests[1]["leaves"]) == sorted(names)
        assert sorted(os.listdir(jpath)) == sorted(os.listdir(tpath))
        for name, info in manifests[0]["leaves"].items():
            np.testing.assert_array_equal(_jax_bits(jpath, info),
                                          _jax_bits(tpath, info))
        # a leaf the filter refused is missing in both
        with pytest.raises(KeyError, match="params/b"):
            jstore.load_checkpoint(jdir, {"params": {"b": 0}})
        with pytest.raises(KeyError, match="params/b"):
            load_checkpoint(tdir, {"params": {"b": 0}}, device="cpu")
    # and the bf16 leaf JAX wrote restores in the port with its bits
    got, _, _ = load_checkpoint(tdir, {"params": {"emb": 0}}, device="cpu")
    jgot, _, _ = load_checkpoint(jdir, {"params": {"emb": 0}}, device="cpu")
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["emb"].view(torch.int16),
                       jgot["params"]["emb"].view(torch.int16))
    assert torch.equal(got["params"]["emb"], as_torch["params"]["emb"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Round 1: JAX saves from 8 devices, 2 port ranks save DTensors.
    Round 2: JAX restores the port's checkpoints on 8 devices; 2 and 4
    port ranks restore JAX's (the 4 also the port's)."""
    root = tmp_path_factory.mktemp("ckpt")
    jdir, pdir = str(root / "jax"), str(root / "port")
    os.makedirs(pdir)
    npz = str(root / "jax_restored.npz")
    fmt = dict(arch=ranks.ARCH, mesh=JAX_MESH, step=JAX_STEP)
    with ThreadPoolExecutor(3) as pool:
        saved = pool.submit(run_jax, JAX_SAVE.format(out=jdir, **fmt))
        port_save = pool.submit(ranks.spawn, 2, "save", (1, 2),
                                str(root / "w2"), [pdir])
        jax_saved, _ = saved.result(), port_save.result()
        restored = pool.submit(run_jax, JAX_RESTORE.format(
            src=pdir, subs=["full0", "rank0", "rank1"], npz=npz,
            **dict(fmt, step=ranks.STEP)))
        load2 = pool.submit(ranks.spawn, 2, "load", (2, 1),
                            str(root / "l2"), [jdir])
        full0 = os.path.join(pdir, "full0")
        load4 = pool.submit(ranks.spawn, 4, "load", (2, 2),
                            str(root / "l4"), [jdir, full0])
        out = dict(jax_saved=jax_saved, jax_restored=restored.result(),
                   arrays=dict(np.load(npz)), load={2: load2.result(),
                                                    4: load4.result()},
                   jdir=jdir, pdir=pdir)
    return out


def _reference():
    return {name: ranks.bits(t) for name, t in
            ranks.flatten(ranks.train_state("cpu"))}


def test_port_dtensor_state_restores_in_jax_on_another_mesh(runs):
    ref = _reference()
    seen = runs["jax_restored"]
    assert seen["full0"]["names"] == sorted(ref)
    assert seen["full0"]["step"] == ranks.STEP
    assert seen["full0"]["extra"] == {"world": 2}
    assert seen["full0"]["sharded"] > 0
    for name, want in ref.items():
        got = runs["arrays"][f"full0:{name}"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # each rank wrote the leaves it owns; together, every leaf once
    owned = [seen[f"rank{r}"]["names"] for r in (0, 1)]
    assert sorted(owned[0] + owned[1]) == sorted(ref)
    for r in (0, 1):
        assert owned[r] == sorted(n for n in ref
                                  if ranks.owner(n, list(ref), 2) == r)
        for name in owned[r]:
            np.testing.assert_array_equal(
                runs["arrays"][f"rank{r}:{name}"], ref[name])


def test_every_rank_saves_the_same_global_state(runs):
    paths = [os.path.join(runs["pdir"], f"full{r}",
                          f"step_{ranks.STEP:08d}") for r in (0, 1)]
    manifests = [json.load(open(os.path.join(p, "manifest.json")))
                 for p in paths]
    assert manifests[0] == manifests[1]
    for info in manifests[0]["leaves"].values():
        np.testing.assert_array_equal(_jax_bits(paths[0], info),
                                      _jax_bits(paths[1], info))


def _expected_local(full: np.ndarray, dims: np.ndarray, coord, mesh):
    """The slice of ``full`` a rank at ``coord`` holds: each sharded mesh
    dimension cuts its tensor dim into equal chunks."""
    index = [slice(None)] * full.ndim
    for axis, dim in enumerate(dims):
        if dim < 0:
            continue
        n = full.shape[dim] // mesh[axis]
        index[dim] = slice(coord[axis] * n, (coord[axis] + 1) * n)
    return full[tuple(index)]


@pytest.mark.parametrize("world,mesh", [(2, (2, 1)), (4, (2, 2))])
def test_jax_state_restores_on_a_gloo_mesh(runs, world, mesh):
    assert runs["jax_saved"]["devices"] == 8
    assert runs["jax_saved"]["sharded"] > 0
    path = os.path.join(runs["jdir"], f"step_{JAX_STEP:08d}")
    leaves = json.load(open(os.path.join(path, "manifest.json")))["leaves"]
    assert {info["dtype"] for name, info in leaves.items()
            if name.startswith("params/")} == {"bfloat16"}
    sharded = 0
    for rank, got in runs["load"][world].items():
        coord = got["coordinate"]
        assert int(got["0:step"]) == JAX_STEP
        for name, info in leaves.items():
            dims = got[f"0:{name}:dims"]
            sharded += bool((dims >= 0).any())
            want = _expected_local(_jax_bits(path, info), dims, coord, mesh)
            local = got[f"0:{name}"]
            assert local.dtype == want.dtype, name
            np.testing.assert_array_equal(local, want)
    assert sharded > 0
    if world == 4:
        # the port's own 2-rank checkpoint, resumed on 4 ranks
        ref = _reference()
        for rank, got in runs["load"][4].items():
            for name, want in ref.items():
                np.testing.assert_array_equal(
                    got[f"1:{name}"],
                    _expected_local(want, got[f"1:{name}:dims"],
                                    got["coordinate"], mesh))
