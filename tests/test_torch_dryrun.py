"""The port's dry-run tier (``repro_torch.launch.dryrun``): a smoke cell
traced on a (2, 2) fake mesh (fake process group and DTensors of fake
tensors, in a subprocess: a process group is process state) writes the
JAX package's dry-run record keys, less the ones that mean nothing
without XLA; a device's FLOPs shrink as the data axis grows, as the JAX
test holds for its pod axis; the long_500k cell of a full-attention
architecture is skipped with JAX's record; and the one-device count of a
smoke train step is held to JAX's ``analyze`` of the same step compiled
on one host device."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest

from repro.launch.hlo_analysis import analyze
from repro.models import input_specs as jispec
from repro.models import steps as jsteps
from repro.models.config import ShapeConfig as JShape
from repro.models.config import get_config as jget_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ShapeConfig, get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's dry-run record keys (src/repro/launch/dryrun.py, compile_cell)
JAX_KEYS = {"arch", "shape", "multi_pod", "mesh", "kind", "kv_repeat",
            "n_params", "n_active_params", "ok", "lower_s", "compile_s",
            "memory", "xla_cost_analysis", "per_device",
            "collective_detail", "roofline", "n_devices", "model_flops",
            "model_flops_per_device", "useful_flops_ratio"}
JAX_MEMORY = {"argument_bytes_per_device", "output_bytes_per_device",
              "temp_bytes_per_device", "alias_bytes_per_device",
              "peak_bytes_per_device"}
# no compile, no XLA, no buffer donation in PyTorch (dryrun's docstring)
LEFT_OUT = {"lower_s", "compile_s", "xla_cost_analysis"}
ADDED = {"trace_s", "launches", "fits"}

_CELLS = """
    import json, os
    before = dict(os.environ)
    import torch.distributed as dist
    from repro_torch.launch.dryrun import cell_record
    # importing the module changes no process state
    imported_clean = dict(os.environ) == before and not dist.is_initialized()
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.config import ShapeConfig, get_config
    cfg = get_config("minitron-4b", smoke=True)
    shape = ShapeConfig("smoke_train", 64, 4, "train")
    out = {"imported_clean": imported_clean}
    for name, sizes in (("2x2", (2, 2)), ("1x1", (1, 1))):
        out[name] = cell_record("minitron-4b", shape.name,
                                Mesh(("data", "model"), sizes), cfg=cfg,
                                shape=shape)
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_CELLS)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_fake_mesh_cell_writes_jax_record_keys(cells):
    rec = cells["2x2"]
    assert rec["ok"] is True and rec["n_devices"] == 4
    assert rec["mesh"] == {"data": 2, "model": 2}
    assert set(rec) == (JAX_KEYS - LEFT_OUT) | ADDED
    assert set(rec["memory"]) == JAX_MEMORY - {"alias_bytes_per_device"}
    assert {"flops", "bytes", "collective_bytes"} <= set(rec["per_device"])
    assert set(rec["roofline"]) >= {"t_compute", "t_memory",
                                    "t_collective", "dominant",
                                    "step_time_lower_bound"}
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["per_device"]["collective_bytes"] > 0
    assert rec["collective_detail"] and all(
        k.split("@")[1].split(":")[0] in ("data", "model")
        for k in rec["collective_detail"])
    assert rec["launches"] == {"flash_fwd": 4, "flash_bwd": 2}
    assert rec["memory"]["peak_bytes_per_device"] >= rec["memory"][
        "argument_bytes_per_device"] > 0
    assert rec["fits"] is True


def test_per_device_flops_shrink_with_the_data_axis(cells):
    one = cells["1x1"]["per_device"]["flops"]
    four = cells["2x2"]["per_device"]["flops"]
    # as JAX's test for its pod axis: sharding the batch must not grow a
    # device's work; here 4 devices quarter it, within the replicated rest
    assert four <= one * 1.1
    assert four <= 0.35 * one
    assert cells["1x1"]["per_device"]["collective_bytes"] == 0
    assert cells["1x1"]["launches"] == cells["2x2"]["launches"]
    assert cells["2x2"]["model_flops_per_device"] == \
        cells["1x1"]["model_flops_per_device"] / 4


def test_long_context_is_skipped_for_full_attention(tmp_path):
    out = str(tmp_path / "dry.jsonl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "stablelm-12b", "--shape", "long_500k", "--multi-pod", "single",
         "--out", out], capture_output=True, text=True, timeout=120,
        env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [json.loads(line) for line in open(out) if line.strip()]
    assert len(rows) == 1
    assert rows[0]["ok"] is None and "sub-quadratic" in rows[0]["skipped"]


def test_importing_the_dryrun_module_changes_no_process_state(cells):
    assert cells["imported_clean"] is True


def test_one_device_flops_near_jax_analyze():
    """The smoke train step of minitron-4b (4 x 64) on one device: the
    port's count within 10 % of JAX's ``analyze`` of the compiled step
    (measured: 0.972 of it). The gap: JAX's smoke step runs the reference
    attention in jnp, whose softmax and mask work XLA counts per element,
    where the port counts the flash kernel by its formula (its two
    products over the causal half); the matmuls of both are the same."""
    jcfg = jget_config("minitron-4b", smoke=True)
    jshape = JShape("s", 64, 4, "train")
    spec = jispec.input_specs(jcfg, jshape)
    compiled = jax.jit(jsteps.make_train_step(jcfg)).lower(
        jsteps.abstract_train_state(jcfg), spec["batch"]).compile()
    jflops = analyze(compiled.as_text())["flops"]
    rec = dryrun.cell_record(
        "minitron-4b", "s", Mesh(("data", "model"), (1, 1)),
        cfg=get_config("minitron-4b", smoke=True),
        shape=ShapeConfig("s", 64, 4, "train"))
    ratio = rec["per_device"]["flops"] / jflops
    assert 0.9 <= ratio <= 1.1, ratio
    assert rec["n_devices"] == 1 and rec["launches"] == {
        "flash_fwd": 4, "flash_bwd": 2}
