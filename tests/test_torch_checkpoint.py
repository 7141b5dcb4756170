"""The port's checkpoint store (``repro_torch.checkpoint``): the JAX
package's cases (``tests/test_checkpoint.py``) on the port, and
checkpoints crossing between the packages. The layout is the JAX one
(``step_%08d/``, ``manifest.json``, one ``.npy`` a leaf named by its dict
path), so a train state written by either package restores in the other,
leaf for leaf.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.models import steps as jsteps
from repro.models.config import get_config as jconfig
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          load_checkpoint, save_checkpoint)
from repro_torch.data import make_stream
from repro_torch.models import steps
from repro_torch.models.config import get_config
from repro_torch.models.convert import train_state_from_numpy


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4)},
            "opt": {"m": torch.zeros(4), "step": torch.tensor(7)}}


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, _tree(), extra={"loss": 1.5})
    restored, step, extra = load_checkpoint(d, _tree(), device="cpu")
    assert step == 5 and extra["loss"] == 1.5
    assert torch.equal(restored["params"]["w"], _tree()["params"]["w"])
    assert restored["opt"]["step"].dtype == torch.int64
    assert restored["opt"]["step"].shape == ()
    names = json.load(open(os.path.join(d, "step_00000005",
                                        "manifest.json")))["leaves"]
    assert sorted(names) == ["opt/m", "opt/step", "params/b", "params/w"]
    assert names["params/w"]["file"] == "params__w.npy"


def test_atomicity_tmp_ignored(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert latest_step(d) == 1
    _, step, _ = load_checkpoint(d, _tree(), device="cpu")
    assert step == 1


def test_manifest_missing_dir_not_latest(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_00000009"))  # no manifest: torn rename
    assert latest_step(d) == 1


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    steps_ = sorted(int(n[5:]) for n in os.listdir(str(tmp_path))
                    if n.startswith("step_"))
    assert steps_ == [3, 4]


def test_async_save_snapshots_before_returning(tmp_path):
    """The device→host copy is made before ``save_async`` returns: an
    in-place update right after it (as the port's AdamW makes) does not
    reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save_async(3, tree, extra={"x": 1})
    tree["params"]["w"].add_(100.0)
    mgr.wait()
    assert mgr.latest() == 3
    restored, _, extra = mgr.restore(_tree(), device="cpu")
    assert torch.equal(restored["params"]["w"], _tree()["params"]["w"])
    assert extra == {"x": 1}


def test_restore_missing_leaf_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        load_checkpoint(d, {"a": torch.zeros(2), "b": torch.zeros(2)},
                        device="cpu")


def test_restore_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(str(tmp_path), {"a": torch.zeros(2)})


def test_train_state_resume_equivalence(tmp_path):
    """Training N steps straight == training k, checkpoint, restore (into
    the meta-device structure of the state), N−k."""
    cfg = get_config("chatglm3-6b", smoke=True)
    stream = make_stream(cfg, 32, 4, seed=1)
    step_fn = steps.make_train_step(cfg)

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in stream.batch(i).items()}

    sA = steps.init_train_state(cfg, 0, "cpu")
    for i in range(4):
        sA, mA = step_fn(sA, batch(i))
    sB = steps.init_train_state(cfg, 0, "cpu")
    for i in range(2):
        sB, _ = step_fn(sB, batch(i))
    d = str(tmp_path)
    save_checkpoint(d, 2, sB)
    sB2, _, _ = load_checkpoint(d, steps.abstract_train_state(cfg),
                                device="cpu")
    for i in range(2, 4):
        sB2, mB = step_fn(sB2, batch(i))
    assert abs(float(mA["loss"]) - float(mB["loss"])) < 2e-4


def _leaves_equal(port_tree, jax_tree):
    flat = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert len(flat) == len(steps.leaves(port_tree))
    for path, want in flat:
        got = port_tree
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert str(got.numpy().dtype) == str(np.asarray(want).dtype)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "rwkv6-3b"])
def test_jax_written_train_state_restores_in_the_port(arch, tmp_path):
    cfg = jconfig(arch, smoke=True)
    state = jax.jit(lambda k: jsteps.init_train_state(cfg, k))(
        jax.random.PRNGKey(3))
    state["opt"]["step"] = jnp.asarray(11, jnp.int32)
    jstore.save_checkpoint(str(tmp_path), 11,
                           jax.tree.map(np.asarray, state),
                           extra={"loss": 2.5})
    restored, step, extra = load_checkpoint(
        str(tmp_path), steps.abstract_train_state(get_config(arch,
                                                             smoke=True)),
        device="cpu")
    assert step == 11 and extra == {"loss": 2.5}
    _leaves_equal(restored, state)
    assert restored["opt"]["step"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "rwkv6-3b"])
def test_port_written_train_state_restores_in_jax(arch, tmp_path):
    cfg = get_config(arch, smoke=True)
    state = steps.init_train_state(cfg, 5, "cpu")
    state["opt"]["step"].fill_(4)
    state["opt"]["m"] = jax.tree.map(torch.randn_like, state["opt"]["m"])
    CheckpointManager(str(tmp_path)).save(4, state, extra={"loss": 1.0})
    abstract = jsteps.abstract_train_state(jconfig(arch, smoke=True))
    restored, step, extra = jstore.load_checkpoint(str(tmp_path), abstract)
    assert step == 4 and extra == {"loss": 1.0}
    _leaves_equal(state, restored)
    # and back: the JAX-restored state converts to the port's, bit for bit
    again = train_state_from_numpy(jax.tree.map(np.asarray, restored),
                                   "cpu")
    for a, b in zip(steps.leaves(again), steps.leaves(state)):
        assert torch.equal(a, b)
