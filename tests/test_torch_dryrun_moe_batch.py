"""The MoE train step with a batch the data axes do not divide: the
dbrx-132b and llama4-maverick smoke configurations at batch 3 on a
(2, 2) fake mesh (a subprocess: a process group is process state).

The JAX package replicates such a batch (``batch_pspecs``) and compiles
the step. The port replicates it too, and its two dispatch groups (192
tokens over 2 data shards) cut the 3 batch rows: the group-sharded
gradient of the tokens' (T, D) view must come back whole before the
(B, S, D) view's backward. Each record is ``ok``, counts one flash
forward and backward a layer, and moves bytes over both axes."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")

_CELLS = """
    import json
    from repro_torch.launch.dryrun import cell_record
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.config import ShapeConfig, get_config
    out = {}
    for arch in __ARCHS__:
        cfg = get_config(arch, smoke=True)
        shape = ShapeConfig("smoke_train", 64, 3, "train")
        rec = cell_record(arch, shape.name, Mesh(("data", "model"), (2, 2)),
                          cfg=cfg, shape=shape)
        out[arch] = {"rec": rec, "n_layers": cfg.n_layers}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    src = textwrap.dedent(_CELLS).replace("__ARCHS__", repr(ARCHS))
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_step_at_batch_3_traces_on_2x2(records, arch):
    rec, n_layers = records[arch]["rec"], records[arch]["n_layers"]
    assert rec["ok"] is True and rec["kind"] == "train"
    assert rec["mesh"] == {"data": 2, "model": 2} and rec["n_devices"] == 4
    assert rec["launches"] == {"flash_fwd": 2 * n_layers,
                               "flash_bwd": n_layers}
    per = rec["per_device"]
    assert per["flops"] > 0 and per["collective_bytes"] > 0
    assert {k.split("@")[1].split(":")[0]
            for k in rec["collective_detail"]} == {"data", "model"}
    assert rec["fits"] is True
