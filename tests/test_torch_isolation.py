"""The port stands alone: it imports neither JAX nor the JAX package, keeps
its own process-global registries, and never falls back to the CPU when
CUDA is asked for."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
PORT = os.path.join(SRC, "repro_torch")


ROOT = os.path.dirname(SRC)


def _blocked(name):
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "jaxlib", "repro"))


def test_every_port_module_imports_with_jax_and_repro_blocked():
    script = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == p or name.startswith(p + ".")
                       for p in ("jax", "jaxlib", "repro")):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = [m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "repro."))
                  or m == "repro"]
        assert not leaked, leaked
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 40
    for name in ("models.config", "models.transformer", "models.mamba2",
                 "models.attention", "models.steps", "models.convert",
                 "configs.zamba2_7b", "configs.rwkv6_3b",
                 "models.rwkv6", "models.moe", "configs.dbrx_132b",
                 "kernels.flash_attention",
                 "kernels.mamba2_ssd", "kernels.rwkv6_wkv", "kernels.ref",
                 "launch.serve", "apps.seismic", "apps.seismic.solver",
                 "apps.seismic.workflow", "optim", "optim.adamw", "data",
                 "data.pipeline", "checkpoint", "checkpoint.store",
                 "launch.train", "optim.compression", "fusion.engine",
                 "launch.mesh"):
        assert "repro_torch." + name in names, name


def test_no_port_source_imports_jax_or_repro():
    offenders = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                offenders += [(path, n) for n in names if _blocked(n)]
    assert not offenders


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_examples_chip_smoke_and_card_helpers_import_no_jax_or_repro():
    """What runs on the card's machine, which has no JAX: the port's
    examples, ``chip_smoke.py`` and the test helpers it loads."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    paths += [os.path.join(ROOT, "examples", f)
              for f in sorted(os.listdir(os.path.join(ROOT, "examples")))
              if f.startswith("torch_") and f.endswith(".py")]
    paths += [os.path.join(ROOT, "tests", f)
              for f in ("_torch_ranks.py", "_torch_update.py",
                        "test_torch_gpu.py")]
    assert len(paths) >= 13
    offenders = [(p, n) for p in paths for n in _imports(p) if _blocked(n)]
    assert not offenders


def test_registries_are_separate_per_package():
    import repro.apps.anen.workflow as jwf
    import repro.core.pst as jpst
    import repro_torch.apps.anen.workflow as twf
    import repro_torch.core.pst as tpst
    for name in ("analog_values", "analog_refine", "round_spread"):
        assert jpst.resolve_executable(f"reg://{name}") is getattr(jwf, name)
        assert tpst.resolve_executable(f"reg://{name}") is getattr(twf, name)
    import repro.apps.seismic.workflow as jsw
    import repro_torch.apps.seismic.workflow as tsw
    for name in ("simulate_earthquake", "eval_misfit", "forward_trial",
                 "trial_misfit"):
        assert jpst.resolve_executable(f"reg://{name}") is getattr(jsw, name)
        assert tpst.resolve_executable(f"reg://{name}") is getattr(tsw, name)
    import repro.core.results as jres
    import repro_torch.core.results as tres
    assert jres._CODECS["fused_array"].__module__ == "repro.fusion.handles"
    assert tres._CODECS["fused_array"].__module__ == \
        "repro_torch.fusion.handles"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    from repro_torch.apps.anen.workflow import run_adaptive
    from repro_torch.apps.seismic.solver import (SeismicConfig,
                                                 make_velocity_model)
    from repro_torch.apps.seismic.workflow import (run_forward_ensemble,
                                                   run_misfit_chain,
                                                   run_misfit_ensemble)
    from repro_torch.device import resolve_device
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train
    from repro_torch.launch.serve import ServeSession, run_managed
    from repro_torch.models.steps import init_train_state
    from repro_torch.models.config import get_config
    from repro_torch.rts.torch_rts import TorchRTS
    for call in (TorchRTS, run_adaptive, resolve_device,
                 lambda: TorchRTS(device="cuda:0"),
                 lambda: ServeSession("zamba2-7b"),
                 lambda: run_managed("zamba2-7b"),
                 lambda: make_velocity_model(SeismicConfig()),
                 lambda: run_misfit_chain(2), lambda: run_misfit_ensemble(2),
                 lambda: run_forward_ensemble(2, 1),
                 lambda: train.TrainSession("minitron-4b", True, 16, 2),
                 lambda: train.run_managed("minitron-4b"),
                 lambda: init_train_state(get_config("minitron-4b",
                                                     smoke=True)),
                 lambda: load_checkpoint("unused", {})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
