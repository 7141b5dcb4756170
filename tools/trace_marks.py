"""Shared parts of the kernel traces (``tools/trace_*.py``).

A trace copies one CUDA source of a tree, splices marks into it at text
anchors (stores of the global timer or ``clock64`` into ``__device__``
arrays), builds the copy with the tree's nvcc flags beside copies of the
tree's headers, launches it and reads the arrays back. This module holds
those steps; each trace keeps only its table of anchors and its phases.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a thread's read of the global timer (ns) into _gt
GLOBALTIMER = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(_gt));'


def splice(text: str, marks, tool: str) -> str:
    """``text`` with each (anchor, mark, after) of ``marks`` applied: the
    mark put after the anchor where ``after``, else before it. Every
    anchor must occur once; else the trace is out of date and ``tool``
    names it."""
    for anchor, mark, after in marks:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once: {anchor!r} "
                             f"(update {tool})")
        text = text.replace(anchor, anchor + mark if after else mark + anchor)
    return text


def readers(*symbols: str) -> str:
    """C source of ``trace_read_<symbol>(host, bytes)`` for each device
    array: copies its first ``bytes`` to ``host``; a CUDA error code."""
    return "".join(
        f'\nextern "C" int trace_read_{s}(void* host, size_t bytes) {{\n'
        f"  return static_cast<int>(cudaMemcpyFromSymbol(host, {s}, "
        f"bytes));\n}}\n" for s in symbols)


def read(lib: ctypes.CDLL, symbol: str, ctype, n: int):
    """The first ``n`` elements of the device array ``symbol``, as a ctypes
    array of ``ctype``."""
    out = (ctype * n)()
    if getattr(lib, f"trace_read_{symbol}")(out, ctypes.sizeof(out)) != 0:
        raise RuntimeError(f"reading {symbol} failed")
    return out


def build(src: str, name: str, cu: str, edit) -> ctypes.CDLL:
    """Builds ``edit(text)`` of ``csrc/<cu>`` of the tree ``src`` (its
    ``src`` directory) into ``build/<name>/`` beside copies of the tree's
    headers, with the tree's nvcc flags, and loads it."""
    from repro_torch.kernels import _build
    out = os.path.join(HERE, "build", name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    csrc = os.path.join(src, "repro_torch", "kernels", "csrc")
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), out)
    with open(os.path.join(csrc, cu)) as f:
        text = edit(f.read())
    with open(os.path.join(out, "k.cu"), "w") as f:
        f.write(text)
    lib_path = os.path.join(out, "libtrace.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(out, "k.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(lib_path)


def quartiles(values) -> list:
    """The first quartile, the median and the third quartile."""
    q = statistics.quantiles(values, n=4)
    return [round(q[0], 1), round(statistics.median(values), 1),
            round(q[2], 1)]
