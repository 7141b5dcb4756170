"""The port's counterparts of the JAX package's device examples
(``examples/{fused_ensemble,federated_fleet,serve_quickstart}.py``), each
run with ``--device cpu`` in a subprocess: each must exit 0 and print
what its JAX counterpart shows (identical fused and scalar values; every
task DONE after a pilot is killed, the device-pinned tasks on the device
pool; two tenants' results and carriers they share)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), "--device",
         "cpu"], capture_output=True, text=True, timeout=180, env=env,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_fused_ensemble_example():
    out = _run("torch_fused_ensemble.py")
    assert "device cpu" in out
    assert "max member drift: 0.00e+00" in out
    assert "fused and scalar runs produced identical member values" in out


def test_federated_fleet_example():
    out = _run("torch_federated_fleet.py")
    assert "all tasks DONE: True" in out
    assert "!! spare pool pilot killed mid-run" in out
    line = next(x for x in out.splitlines()
                if x.startswith("train results on devices:"))
    assert line.count("['cpu']") == 4


def test_serve_quickstart_example():
    out = _run("torch_serve_quickstart.py")
    assert "research: sq-0=0.0 sq-7=49.0" in out
    assert "prod: sq-0=10000.0 sq-7=11449.0" in out
    shared = next(x for x in out.splitlines()
                  if x.startswith("cross-tenant carriers:"))
    assert int(shared.split(":")[1]) >= 1
