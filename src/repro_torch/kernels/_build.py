"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``kernels/csrc/<name>.cu`` exposes a plain C launcher and compiles on
its own into ``build/repro_torch_kernels/lib<name>-<digest>.so`` under the
repository root, at first use. The digest covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source never loads a
stale library. A build or load failure
raises; nothing here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of repro_torch build only where the toolkit is")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def compile_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path. Safe to run for several sources at once (one process
    each): the output is written under a temporary name and renamed."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    sys.stderr.write(proc.stderr)   # ptxas: registers, shared memory, spills
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_library(name)))
            _loaded[name] = lib
        return lib


INFO_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
             "spill_bytes", "blocks_per_sm", "threads")


def kernel_info(name: str, *args: int) -> dict:
    """What the compiler and the card made of a kernel of
    ``csrc/<name>.cu``, through its C function ``<name>_info(*args,
    int* info)``: registers a thread, static and dynamic shared memory a
    block, spill bytes a thread, blocks resident on one SM and threads a
    block (``cudaFuncGetAttributes`` and the occupancy API)."""
    fn = getattr(load(name), f"{name}_info")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(INFO_KEYS))()
    err = fn(*args, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"{name}_info failed: CUDA error {err}")
    return dict(zip(INFO_KEYS, info))


if __name__ == "__main__":
    # `python -m repro_torch.kernels._build <name>`: compile one source
    # (chip_smoke.py starts one such process per source, all at once)
    for arg in sys.argv[1:]:
        print(compile_library(arg))
