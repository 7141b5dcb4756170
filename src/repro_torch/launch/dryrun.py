"""The dry-run: what every (architecture × shape × mesh) cell needs a
device, without a device.

The counterpart of the JAX package's ``launch/dryrun.py``. For each cell:

    with fake process group of the mesh's size, FakeTensorMode():
        state  = DTensors of fake tensors, placed by param_specs /
                 train_state_specs (batch_pspecs, cache_pspecs, token_pspec
                 for the inputs)
        with activation_ctx(mesh, param_pspecs), OpAnalysis(...):
            make_{train,prefill,decode}_step(cfg)(state, inputs)

and one JSON line a cell: the per-device peak memory (the live bytes of
rank 0's fake storages, autograd's saved tensors and the optimizer state
included), the per-device flops, bytes and collective bytes
(:mod:`.op_analysis`), the roofline terms on H100 spec-sheet peaks, and
the model FLOPs. Nothing is allocated and no device is touched: a fake
tensor has shapes and dtypes only, and each hand-written kernel is one op
with a cost formula (:mod:`repro_torch.kernels.costs`).

A record has the JAX package's keys, except what has no meaning here:
``lower_s`` and ``compile_s`` (nothing is compiled: ``trace_s`` instead),
``xla_cost_analysis`` (no XLA) and ``memory.alias_bytes_per_device`` (no
buffer donation: the port updates its state in place). It adds
``launches`` (each kernel op's calls), ``fits`` (peak within one H100's 80
GB) and ``per_device.collective_bytes_{nvlink,network}``.

Importing this module changes no process state. A process group is
started only inside :func:`fake_process_group` (around one cell), and one
cell runs in its own process when several are asked for. A mesh of one
device skips DTensor and the process group altogether: plain fake tensors
on ``device`` (this is the form the card checks, against the peak memory
and launches of the real step).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
        --shape train_4k --multi-pod both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..models import input_specs as ispec
from ..models import sharding as shd
from ..models import steps as steps_mod
from ..models.config import SHAPES, ModelConfig, ShapeConfig, get_config
from ..models.config import list_archs
from ..models.pspec_ctx import activation_ctx
from .mesh import Mesh, make_production_mesh
from .op_analysis import (OpAnalysis, ignoring_sharding_propagation,
                          roofline_terms)

HBM_CAPACITY = 80e9     # one H100 SXM5's HBM3, 80 GB (spec sheet)
SKIP_REASON = "full-attention arch: no sub-quadratic path at 524288 ctx"


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    0, for the duration: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _cuda_alltoall():
    """DTensor's shard-to-shard moves as the all-to-all a CUDA mesh runs:
    on a CPU mesh DTensor falls back to all-gather + chunk (gloo has no
    all-to-all), which is not what an H100 cluster does."""
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed._functional_collectives import (
            _group_or_group_name, _resolve_group)
        group = _resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, _group_or_group_name(group))
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


def _placed(meta: torch.Tensor, spec, mesh: Mesh, device) -> torch.Tensor:
    """A fake tensor of ``meta``'s global shape and dtype on ``device``:
    as a DTensor placed by ``spec`` when the mesh has more than one
    device (its local shard allocated), else plain. Called under the fake
    mode."""
    if mesh.device_mesh is None:
        return torch.empty(meta.shape, dtype=meta.dtype, device=device)
    from torch.distributed.tensor import DTensor, Shard
    placements = shd.to_placements(spec, mesh)
    local = list(meta.shape)
    for size, p in zip(mesh.sizes, placements):
        if isinstance(p, Shard):
            local[p.dim] //= size
    t = torch.empty(local, dtype=meta.dtype, device=device)
    return DTensor.from_local(t, mesh.device_mesh, placements,
                              run_check=False, shape=meta.shape,
                              stride=torch.empty(meta.shape,
                                                 device="meta").stride())


def _place_tree(tree, specs, mesh: Mesh, device):
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh, device)
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree                      # a cache's int length
    return _placed(tree, specs, mesh, device)


def run_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
             device: str = "cpu") -> Dict[str, Any]:
    """Trace one cell's step on fake tensors over ``mesh`` (a
    :class:`~.mesh.Mesh` whose ``device_mesh`` is set when it has more
    than one device) → the per-device counts and memory. ``cfg`` is used
    as given (its ``kv_repeat`` included)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    specs_in = ispec.input_specs(cfg, shape)
    p_specs = shd.param_specs(cfg, mesh)
    fake = FakeTensorMode(allow_non_fake_inputs=False)
    multi = mesh.device_mesh is not None
    t0 = time.perf_counter()
    with fake:
        if shape.kind == "train":
            state = _place_tree(steps_mod.abstract_train_state(cfg),
                                shd.train_state_specs(cfg, mesh), mesh,
                                device)
            args = (state, _place_tree(specs_in["batch"],
                                       shd.batch_pspecs(cfg, shape, mesh),
                                       mesh, device))
            fn = steps_mod.make_train_step(cfg)
        else:
            params = _place_tree(steps_mod.transformer.abstract_params(cfg),
                                 p_specs, mesh, device)
            if shape.kind == "prefill":
                args = (params, _place_tree(
                    specs_in["batch"], shd.batch_pspecs(cfg, shape, mesh),
                    mesh, device))
                fn = steps_mod.make_prefill_step(cfg)
            else:
                args = (params,
                        _placed(specs_in["token"],
                                shd.token_pspec(cfg, shape, mesh), mesh,
                                device),
                        _place_tree(specs_in["cache"],
                                    shd.cache_pspecs(cfg, shape, mesh),
                                    mesh, device))
                fn = steps_mod.make_decode_step(cfg)
        analysis = OpAnalysis(mesh=mesh, fake_mode=fake)
        analysis.track(*args)
        argument = analysis.live
        with contextlib.ExitStack() as stack:
            if multi:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
                stack.enter_context(_cuda_alltoall())
                stack.enter_context(ignoring_sharding_propagation())
            stack.enter_context(activation_ctx(mesh, p_specs))
            stack.enter_context(analysis)
            out = fn(*args)
        output = max(0, analysis.live - argument)
        del out
    per = analysis.per_device()
    return {"trace_s": time.perf_counter() - t0, "argument": argument,
            "output": output, "per_device": per}


def _model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·D for training, 2·N_active·D to serve (D the tokens)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    return 2.0 * n * tokens


def cell_record(arch: str, shape_name: str, mesh: Mesh,
                multi_pod: Optional[bool] = None, device: str = "cpu",
                cfg: Optional[ModelConfig] = None,
                shape: Optional[ShapeConfig] = None,
                verbose: bool = False) -> Dict[str, Any]:
    """One cell's record, JAX's keys (see the module docstring). Starts
    and ends the fake process group itself when ``mesh`` has more than one
    device and no device mesh yet. ``cfg`` and ``shape`` override the
    registry's (a smoke configuration, a small shape)."""
    shape = shape or SHAPES[shape_name]
    cfg = cfg or get_config(arch)
    cfg = cfg.replace(kv_repeat=shd.kv_repeat_for(cfg, mesh))
    with contextlib.ExitStack() as stack:
        if mesh.size > 1 and mesh.device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh
            stack.enter_context(fake_process_group(mesh.size))
            mesh = mesh.with_device_mesh(init_device_mesh(
                device, mesh.sizes, mesh_dim_names=mesh.axis_names))
        res = run_cell(cfg, shape, mesh, device)
    per = res["per_device"]
    peak = per["peak_bytes"]
    n_dev = mesh.size
    model_flops = _model_flops(cfg, shape)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "multi_pod": multi_pod,
        "mesh": mesh.shape, "kind": shape.kind, "kv_repeat": cfg.kv_repeat,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "ok": True, "trace_s": round(res["trace_s"], 2),
        "memory": {
            "argument_bytes_per_device": res["argument"],
            "output_bytes_per_device": res["output"],
            "temp_bytes_per_device": max(
                0, peak - res["argument"] - res["output"]),
            "peak_bytes_per_device": peak,
        },
        "per_device": {
            "flops": per["flops"], "bytes": per["bytes"],
            "collective_bytes": per["collective_bytes"],
            "collective_bytes_nvlink": per["collective_bytes_nvlink"],
            "collective_bytes_network": per["collective_bytes_network"],
            "matmul_flops": per["matmul_flops"],
            "kernel_flops": per["kernel_flops"],
        },
        "collective_detail": per["collective_detail"],
        "roofline": roofline_terms(per),
        "launches": per["launches"],
        "n_devices": n_dev,
        "fits": peak <= HBM_CAPACITY,
        "model_flops": model_flops,
        "model_flops_per_device": model_flops / n_dev,
        "useful_flops_ratio": model_flops / n_dev / max(1.0, per["flops"]),
    }
    if verbose:
        r = record["roofline"]
        print(f"[dryrun] {arch} × {shape.name} × "
              f"{'x'.join(map(str, mesh.sizes))}: trace "
              f"{record['trace_s']}s  peak/dev {peak / 1e9:.2f} GB  "
              f"t_comp {r['t_compute'] * 1e3:.2f}ms  "
              f"t_mem {r['t_memory'] * 1e3:.2f}ms  "
              f"t_coll {r['t_collective'] * 1e3:.2f}ms  "
              f"dominant={r['dominant']}  "
              f"useful={record['useful_flops_ratio']:.2f}", flush=True)
    return record


def _one(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """One cell on a production mesh, in a process of its own (the
    ``--one`` entry)."""
    return cell_record(arch, shape_name,
                       make_production_mesh(multi_pod=multi_pod),
                       multi_pod=multi_pod, verbose=True)


def _spawn(arch: str, shape_name: str, multi_pod: bool,
           timeout: float) -> Dict[str, Any]:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--one",
           arch, shape_name, "multi" if multi_pod else "single"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "ok": False, "error": f"timeout after {timeout} s"}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        print("\n".join(lines[:-1]), flush=True)
        return json.loads(lines[-1])
    err = (proc.stderr.strip().splitlines() or ["no output"])[-1]
    return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "ok": False, "error": err}


def run_cells(archs, shapes, multi_pod_modes, out_path: str,
              stop_on_error: bool = False, jobs: int = 1,
              timeout: float = 1800.0) -> int:
    """Every (arch, shape, mesh) cell, each in its own process (``jobs``
    at a time), appended to ``out_path`` as JSON lines; long_500k is
    skipped for full-attention archs, as in the JAX package. Returns the
    number of failed cells."""
    from concurrent.futures import ThreadPoolExecutor
    failures = 0
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    todo = []
    with open(out_path, "a") as fh:
        for arch in archs:
            cfg = get_config(arch)
            for shape_name in shapes:
                if shape_name == "long_500k" and not cfg.sub_quadratic:
                    rec = {"arch": arch, "shape": shape_name, "ok": None,
                           "skipped": SKIP_REASON}
                    fh.write(json.dumps(rec) + "\n")
                    print(f"[dryrun] {arch} × {shape_name}: SKIP "
                          f"(full attention)", flush=True)
                    continue
                todo.extend((arch, shape_name, mp) for mp in multi_pod_modes)
        with ThreadPoolExecutor(max_workers=max(1, jobs)) as pool:
            futures = [pool.submit(_spawn, *cell, timeout) for cell in todo]
            for fut in futures:
                rec = fut.result()
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
                if not rec.get("ok"):
                    failures += 1
                    print(f"[dryrun] {rec['arch']} × {rec['shape']} "
                          f"mp={rec['multi_pod']}: FAIL {rec['error']}",
                          flush=True)
                    if stop_on_error:
                        for f in futures:
                            f.cancel()
                        return failures
    return failures


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--stop-on-error", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    ap.add_argument("--one", nargs=3, metavar=("ARCH", "SHAPE", "MESH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        arch, shape_name, which = args.one
        try:
            rec = _one(arch, shape_name, which == "multi")
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape_name,
                   "multi_pod": which == "multi", "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec))
        return
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    modes = {"single": [False], "multi": [True],
             "both": [False, True]}[args.multi_pod]
    failures = run_cells(archs, shapes, modes, args.out,
                         stop_on_error=args.stop_on_error, jobs=args.jobs)
    print(f"[dryrun] done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
