"""The port's new examples (``examples/torch_{fused_ensemble,
federated_fleet,serve_quickstart}.py``) default to the card, as every
entry point of the port does: without ``--device``, on a machine without
CUDA, each raises instead of running on the CPU. (Their CPU runs:
``tests/test_torch_examples.py``.)"""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["torch_fused_ensemble.py",
                                  "torch_federated_fleet.py",
                                  "torch_serve_quickstart.py"])
def test_examples_default_to_the_card(name):
    """Without ``--device`` each example asks for CUDA, and on a machine
    without it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        name)],
                          capture_output=True, text=True, timeout=180,
                          env=env, cwd=ROOT)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
