"""The benchmark loads nothing of the JAX stack or the JAX package: the
run's own check by whole top-level names, and a process that loads every
module of the harness with the port."""

import ast
import subprocess
import sys

from perfbench import run as bench_run
from perfbench.tests import cases


def test_the_check_compares_whole_top_level_names():
    check = bench_run.forbidden_modules
    assert check(["repro_torch", "repro_torch.kernels", "reprox", "jaxtyping",
                  "torch"]) == []
    assert check(["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (cases.ROOT / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in bench_run.FORBIDDEN, (path, n)


def test_the_reference_imports_nothing_of_the_program():
    for path in (cases.ROOT / "perfbench" / "reference").rglob("*.py"):
        assert "repro_torch" not in path.read_text(), path


def test_a_process_with_the_harness_and_the_port_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "import perfbench.run as r\n"
        "import perfbench.harness.serve_cell, perfbench.harness.readers\n"
        "import perfbench.control, perfbench.reference.chatglm\n"
        "import perfbench.costs.flash_attention\n"
        "import repro_torch.launch.serve, repro_torch.kernels\n"
        "import repro_torch.rts.torch_rts\n"
        "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(cases.ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(cases.ROOT / "perfbench" / "run.py"),
         "--workload", cases.PREFILL, "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
