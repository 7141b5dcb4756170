"""Per-rank gradients for the data-axis mean of int8 compression, and a
runner that spawns a ``torch.distributed`` group of processes over them.

Shared by ``tests/test_torch_compression_mean.py`` (a gloo group of 4 on
the CPU against JAX's ``shard_map`` ``pmean``), the card test and
``chip_smoke.py``. The inputs are numpy only: the JAX side and the port
take the same float32 arrays and cast the ``bfloat16`` leaves themselves
(round to nearest even in both).

Run as a script, this file is one rank:
``python tests/_torch_ranks.py RANK WORLD BACKEND DEVICE STORE OUT CASES``
joins the group through the file store ``STORE``, runs the comma-joined
:data:`CASES` for :data:`STEPS` steps of error feedback, and writes every
case's means and error states to ``OUT`` (an ``.npz``).
:func:`expected` computes the same on the CPU in one process, from the
port's compression alone: the plain version of the group's mean.
"""

import os
import subprocess
import sys
from typing import Dict, Iterator, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2026
STEPS = 2
# leaf name -> (shape, dtype): a nested dict of f32 and bf16 leaves whose
# sizes cross the 2048-value block both ways
LEAVES = {"blk/w": ((3, 1500), "float32"), "blk/b": ((700,), "bfloat16"),
          "head": ((5000,), "float32"), "scale": ((7,), "bfloat16")}
# case -> (mesh shape or None for the default group, axis name)
CASES = {"world": (None, "data"),
         "mesh_data": ((2, 2), "data"),
         "mesh_model": ((2, 2), "model")}


def grads(rank: int, step: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s flat gradient leaves at ``step`` (float32 values;
    each side casts to the leaf's dtype)."""
    rng = np.random.default_rng((SEED, rank, step))
    return {name: (rng.standard_normal(shape) * (1 + 3 * i)).astype(
                np.float32)
            for i, (name, (shape, _)) in enumerate(LEAVES.items())}


def first_error(rank: int) -> Dict[str, np.ndarray]:
    """A seeded, non-zero first error state (float32)."""
    rng = np.random.default_rng((SEED, rank, STEPS))
    return {name: (rng.standard_normal(shape) * 1e-2).astype(np.float32)
            for name, (shape, _) in LEAVES.items()}


def nest(flat: Dict) -> Dict:
    out: Dict = {}
    for name, v in flat.items():
        *parents, leaf = name.split("/")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def flatten(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def groups(world: int, case: str):
    """The ranks whose mean each rank takes in ``case``: all of them, or
    a row or column of the (2, 2) ``("data", "model")`` mesh (rank =
    2 * data + model)."""
    shape, axis = CASES[case]
    if shape is None:
        return [list(range(world))]
    if axis == "data":
        return [[m, 2 + m] for m in range(2)]
    return [[2 * d, 2 * d + 1] for d in range(2)]


def expected(world: int, case: str) -> Dict[int, Dict[str, np.ndarray]]:
    """rank → the outputs :func:`spawn` should give for ``case``, computed
    on the CPU in this process: each rank's target, its int8 round trip
    and new error, and the sum of the group's dequantized payloads over the
    group's size, cast to the leaf's dtype."""
    import torch

    from repro_torch.optim.compression import (compress_int8,
                                               decompress_int8)

    dtypes = {name: getattr(torch, dt) for name, (_, dt) in LEAVES.items()}
    err = {r: {k: torch.from_numpy(v) for k, v in first_error(r).items()}
           for r in range(world)}
    out: Dict[int, Dict[str, np.ndarray]] = {r: {} for r in range(world)}
    for step in range(STEPS):
        deq = {}
        for r in range(world):
            for k, v in grads(r, step).items():
                target = torch.from_numpy(v).to(dtypes[k]).float() \
                    + err[r][k]
                q, sc = compress_int8(target)
                deq[r, k] = decompress_int8(q, sc, target.shape)
                err[r][k] = target - deq[r, k]
                out[r][f"{case}/{step}/error/{k}"] = err[r][k].numpy()
        for members in groups(world, case):
            for k in LEAVES:
                total = deq[members[0], k].clone()
                for r in members[1:]:
                    total += deq[r, k]
                mean = (total / len(members)).to(dtypes[k]).float()
                for r in members:
                    out[r][f"{case}/{step}/mean/{k}"] = mean.numpy()
    return out


def spawn(world: int, backend: str, device: str, workdir: str,
          cases=tuple(CASES), timeout: float = 120.0
          ) -> Dict[int, Dict[str, np.ndarray]]:
    """Run ``world`` ranks of this file as processes over ``cases``, each
    on ``device`` (``"cuda:{rank}"``: a card a rank); → rank → its
    outputs. Every process is waited for (or killed) before returning."""
    store = os.path.join(workdir, "store")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         backend, device, store, os.path.join(workdir, f"rank{r}.npz"),
         ",".join(cases)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{log}")
    return {r: dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)}


def _rank_main(rank: int, world: int, backend: str, device: str,
               store: str, out: str, cases: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.compression import ef_compressed_mean

    dev = torch.device(device.replace("{rank}", str(rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    dtypes = {name: getattr(torch, dt) for name, (_, dt) in LEAVES.items()}
    saved = {}
    try:
        for case in cases.split(","):
            shape, axis = CASES[case]
            mesh = None
            if shape is not None:
                dm = init_device_mesh(dev.type, shape,
                                      mesh_dim_names=("data", "model"))
                # the port's Mesh carries the DeviceMesh for one case,
                # the bare DeviceMesh serves the other
                mesh = (Mesh(("data", "model"), shape).with_device_mesh(dm)
                        if axis == "model" else dm)
            err = nest({k: torch.from_numpy(v).to(dev)
                        for k, v in first_error(rank).items()})
            for step in range(STEPS):
                g = nest({k: torch.from_numpy(v).to(dev).to(dtypes[k])
                          for k, v in grads(rank, step).items()})
                mean, err = ef_compressed_mean(g, err, axis, mesh=mesh)
                for name, v in flatten(mean):
                    assert v.dtype == dtypes[name] and v.device == dev
                    saved[f"{case}/{step}/mean/{name}"] = \
                        v.float().cpu().numpy()
                for name, v in flatten(err):
                    assert v.dtype == torch.float32
                    saved[f"{case}/{step}/error/{name}"] = v.cpu().numpy()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        dist.destroy_process_group()
    np.savez(out, **saved)


if __name__ == "__main__":
    r, w, backend, device, store, out, cases = sys.argv[1:8]
    _rank_main(int(r), int(w), backend, device, store, out, cases)
