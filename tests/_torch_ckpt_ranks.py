"""Ranks of a ``torch.distributed`` group that save and restore a train
state through the port's checkpoint store with DTensor leaves.

Shared by ``tests/test_torch_checkpoint_sharded.py`` (gloo groups of 2 and
4 on the CPU, against the JAX store on 8 forced host devices) and the card
test (an NCCL group of one). The state is the smoke configuration
:data:`ARCH`'s, each leaf placed by the port's sharding rules
(``named(mesh, train_state_specs(cfg, mesh))``) on a ``("data",
"model")`` mesh.

Run as a script, this file is one rank:
``python tests/_torch_ckpt_ranks.py RANK WORLD BACKEND DEVICE STORE JOB
DATA MODEL OUT SRC...`` joins the group through the file store
``STORE`` and

* ``save``: places :func:`train_state` on the mesh as DTensors and saves
  it twice: into ``SRC/rank<RANK>`` with a ``shard_filter`` that keeps
  the leaves the rank owns (:func:`owner`), and whole through
  ``CheckpointManager.save_async`` into ``SRC/full<RANK>``;
* ``load``: restores each ``SRC`` onto the mesh with shardings and writes
  every leaf's local shard (its bits), its placements and the rank's mesh
  coordinate to ``OUT`` (an ``.npz``).
"""

import os
import subprocess
import sys
from typing import Dict, Iterator, List, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-vl-2b"
SEED = 5
STEP = 7


def flatten(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) in sorted key order, the store's leaf names."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def owner(name: str, names: List[str], world: int) -> int:
    """The rank that writes leaf ``name`` in a per-rank save."""
    return sorted(names).index(name) % world


def train_state(device="cpu") -> Dict:
    """The smoke configuration's f32 train state from :data:`SEED`, with
    seeded non-zero moments and step :data:`STEP` (the same on every
    rank)."""
    import torch

    from repro_torch.models import steps
    from repro_torch.models.config import get_config
    state = steps.init_train_state(get_config(ARCH, smoke=True), SEED,
                                   device)
    gen = torch.Generator().manual_seed(SEED)

    def draw(tree, fn):
        return {k: (draw(v, fn) if isinstance(v, dict)
                    else fn(v.shape, generator=gen).to(v.device))
                for k, v in sorted(tree.items())}
    state["opt"]["m"] = draw(state["opt"]["m"], torch.randn)
    state["opt"]["v"] = draw(state["opt"]["v"], torch.rand)
    state["opt"]["step"].fill_(STEP)
    return state


def bits(t) -> np.ndarray:
    """A CPU tensor's elements as numpy, bfloat16 as its int16 bits."""
    import torch
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def shard_dims(placements) -> np.ndarray:
    """Each mesh dimension's sharded tensor dim, -1 where replicated."""
    return np.array([getattr(p, "dim", -1) if p.is_shard() else -1
                     for p in placements], np.int64)


def spawn(world: int, job: str, mesh: Tuple[int, int], workdir: str,
          srcs: List[str], backend: str = "gloo", device: str = "cpu",
          timeout: float = 120.0) -> Dict[int, Dict[str, np.ndarray]]:
    """Run ``world`` ranks of this file as processes; → rank → its
    outputs. Every process is waited for (or killed) before returning."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store-{job}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    outs = [os.path.join(workdir, f"{job}-rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         backend, device, store, job, str(mesh[0]), str(mesh[1]), outs[r],
         *srcs],
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
    return {r: dict(np.load(outs[r])) for r in range(world)}


def _rank_main(rank: int, world: int, backend: str, device: str,
               store: str, job: str, mesh_shape: Tuple[int, int], out: str,
               srcs: List[str]) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                        save_checkpoint)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import steps
    from repro_torch.models.config import get_config
    from repro_torch.models.sharding import named, train_state_specs

    dev = torch.device(device.replace("{rank}", str(rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    saved: Dict[str, np.ndarray] = {}
    try:
        dm = init_device_mesh(dev.type, mesh_shape,
                              mesh_dim_names=("data", "model"))
        cfg = get_config(ARCH, smoke=True)
        rules = Mesh(("data", "model"), mesh_shape)
        places = named(rules, train_state_specs(cfg, rules))
        saved["coordinate"] = np.array(dm.get_coordinate(), np.int64)
        if job == "save":
            full = train_state(dev)
            placed = dict(flatten(places))
            state = steps.unflatten(full, [
                distribute_tensor(t, dm, list(placed[name]),
                                  src_data_rank=None)
                for name, t in flatten(full)])
            names = [name for name, _ in flatten(state)]
            assert any(p.is_shard() for _, t in flatten(state)
                       for p in t.placements)
            for src in srcs:
                save_checkpoint(os.path.join(src, f"rank{rank}"), STEP,
                                state, extra={"world": world},
                                shard_filter=lambda n: owner(
                                    n, names, world) == rank)
                mgr = CheckpointManager(os.path.join(src, f"full{rank}"))
                mgr.save_async(STEP, state, extra={"world": world})
                mgr.wait()
        else:
            shardings = {}
            for name, pl in flatten(places):
                shardings[name] = (dm, pl)
            like = steps.abstract_train_state(cfg)
            pairs = steps.unflatten(like, [shardings[n]
                                           for n, _ in flatten(like)])
            for i, src in enumerate(srcs):
                tree, step, _ = load_checkpoint(src, like, device=dev,
                                                shardings=pairs)
                saved[f"{i}:step"] = np.array(step)
                for name, leaf in flatten(tree):
                    assert isinstance(leaf, DTensor), name
                    assert tuple(leaf.placements) == tuple(
                        shardings[name][1]), name
                    local = leaf.to_local()
                    assert local.device.type == dev.type, name
                    saved[f"{i}:{name}"] = bits(local.cpu())
                    saved[f"{i}:{name}:dims"] = shard_dims(leaf.placements)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        dist.destroy_process_group()
    np.savez(out, **saved)


if __name__ == "__main__":
    r, w, backend, device, store, job, d, m, out = sys.argv[1:10]
    _rank_main(int(r), int(w), backend, device, store, job, (int(d), int(m)),
               out, sys.argv[10:])
