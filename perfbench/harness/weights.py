"""Weights from the seed, made on the device in the type they are served in.

Each leaf (per-layer leaves are stacked, so a model is a dozen leaves) is
one draw of its own generator on the device, seeded from (seed, leaf
index). The reference draws the same leaves again after the program is
freed, and takes them in float32: the served bf16 values, upcast exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def leaf_seed(seed: int, index: int) -> int:
    """A 64-bit seed for leaf ``index`` of a model drawn from ``seed``."""
    seq = np.random.SeedSequence([seed % 2 ** 64, 0x5EED, index])
    return int(seq.generate_state(1, np.uint64)[0])


def leaf_dtype(spec_item, matmul_dtype: torch.dtype) -> torch.dtype:
    """Matmul weights in ``matmul_dtype``, every other leaf in f32."""
    return matmul_dtype if spec_item[4] else torch.float32


def draw(spec_item, seed: int, index: int, device,
         matmul_dtype: torch.dtype) -> torch.Tensor:
    """One leaf of ``spec_item`` = (path, shape, init, args, matmul)."""
    _, shape, init, args, _ = spec_item
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    kw = dict(dtype=leaf_dtype(spec_item, matmul_dtype), device=device,
              generator=gen)
    if init == "normal":
        return torch.randn(shape, **kw).mul_(args[0])
    if init == "uniform":
        return torch.rand(shape, **kw).mul_(args[1] - args[0]).add_(args[0])
    raise ValueError(f"unknown init {init!r}")


def make(spec, seed: int, device, matmul_dtype: torch.dtype) -> Dict:
    """The nested dict of every leaf of ``spec``."""
    tree: Dict = {}
    for i, item in enumerate(spec):
        node = tree
        for key in item[0][:-1]:
            node = node.setdefault(key, {})
        node[item[0][-1]] = draw(item, seed, i, device, matmul_dtype)
    return tree


def check_layout(spec, abstract: Dict, matmul_dtype: torch.dtype) -> None:
    """Raise unless ``abstract`` (the program's parameters on the meta
    device) has exactly the paths, shapes and dtypes of ``spec``."""
    flat = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = (tuple(v.shape), v.dtype)
    walk(abstract)
    want = {item[0]: (tuple(item[1]), leaf_dtype(item, matmul_dtype))
            for item in spec}
    if flat != want:
        diff = sorted(set(flat.items()) ^ set(want.items()), key=str)
        raise RuntimeError(f"the program's parameter layout differs from "
                           f"the benchmark's: {diff[:6]}")
