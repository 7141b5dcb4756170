"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each kernel against its plain PyTorch version on the card, drives the main
path — the adaptive AnEn ensemble (``repro_torch.apps.anen.workflow``) at
the NCEP NAM 12 km CONUS grid, 428 x 614 points (AWIPS grid 218), with 365
daily historical runs — and checks that every fused dispatch went through
the kernels. Then it checks the run against the same run on the CPU at a
small size. Every phase raises on failure, so a failed phase exits non-zero
and prints no result. Without CUDA, or without the rest of the repository
beside it, it fails.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# every CUDA source of the port (src/repro_torch/kernels/csrc/<name>.cu)
KERNEL_SOURCES = ("anen_distance",)

# published peaks of one H100 SXM (NVIDIA data sheet) at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

MAIN = dict(seed=0, ny=428, nx=614, n_hist=365, per_iter=1024, max_iters=4,
            n_tasks=8, slots=4, timeout=900.0)
SMALL = dict(seed=3, ny=20, nx=20, n_hist=30, per_iter=16, max_iters=2,
             n_tasks=4, slots=4, timeout=120.0)
EQUAL_SHAPES = ((60, 3, 37), (9, 2, 130), (365, 3, 1024), (365, 3, 4096))
TIMED_SHAPES = ((365, 3, 1024), (365, 3, 4096))
TIMED_REPS = 60


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    """One nvcc per source, all started together; then load them."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.kernels._build",
                               name], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for name in KERNEL_SOURCES]
    for name, proc in zip(KERNEL_SOURCES, procs):
        out, err = proc.communicate()
        check(proc.returncode == 0, f"build of {name}.cu: {err}")
        print(f"built {name}: {out.strip()}\n{err.strip()}")
    from repro_torch.kernels import anen_distance as kmod
    kmod.build()
    return time.perf_counter() - t0


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def device_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median device time of one call: ``reps`` calls queued back to back
    behind a spin kernel, with a CUDA event between consecutive calls, so
    the host's enqueue cost never shows as device time. The spin doubles
    until it outlasts the enqueue (the first event must still be pending
    when the host has queued everything)."""
    import torch
    for _ in range(5):
        fn()
    cycles = 1 << 24
    while True:
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(reps + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        for i in range(reps):
            events[i].record()
            fn()
        events[reps].record()
        covered = not events[0].query()
        events[reps].synchronize()
        if covered:
            return _median([events[i].elapsed_time(events[i + 1])
                            for i in range(reps)])
        cycles *= 4


def call_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median time of one call as a caller sees it: CUDA events around a
    single call on an idle device, so the wrapper's host cost counts."""
    import torch
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return _median(times)


def distance_inputs(shape, seed: int = 7):
    import numpy as np
    import torch
    h, v, n = shape
    rng = np.random.default_rng(seed)
    fh = torch.from_numpy(rng.standard_normal((h, v, n)).astype(np.float32))
    fn = torch.from_numpy(rng.standard_normal((v, n)).astype(np.float32))
    return fh.cuda(), fn.cuda()


def distance_bound(shape) -> dict:
    """Least time for (H, V, N): each input read once and the output
    written once, in f32, against 3·H·V·N f32 operations."""
    h, v, n = shape
    bytes_ = 4 * (h * v * n + v * n + h * n)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * h * v * n / FP32_FLOPS_PER_S * 1e3
    return {"bytes": bytes_, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare_distance(shape) -> dict:
    """Kernel vs plain version on the card, on the same inputs: they must
    be bit-equal (tolerance 0: same operation order, no FMA)."""
    import torch
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_plain)
    fh, fn = distance_inputs(shape)
    got = anen_distance(fh, fn)
    ref = anen_distance_plain(fh, fn)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err == 0.0, f"anen_distance bit-equal to plain at {shape} "
                      f"(max abs err {err})")
    return {"shape": list(shape), "max_abs_err": err}


def time_distance(shape) -> dict:
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_plain)
    fh, fn = distance_inputs(shape)
    kernel = lambda: anen_distance(fh, fn)            # noqa: E731
    plain = lambda: anen_distance_plain(fh, fn)       # noqa: E731
    row = {"shape": list(shape),
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel), "plain_call_ms": call_ms(plain)}
    row.update(distance_bound(shape))
    return row


def run_main_path() -> dict:
    import torch
    from repro_torch.apps.anen import workflow as wf
    from repro_torch.kernels.anen_distance import anen_distance
    torch.cuda.reset_peak_memory_stats()
    anen_distance.launches = 0
    anen_distance.shapes.clear()
    runs = {}
    for method in ("run_adaptive", "run_random"):
        before = anen_distance.launches
        t0 = time.perf_counter()
        res = getattr(wf, method)(device="cuda", **MAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = res["fusion_stats"]
        print(f"{method}: all_done={res['all_done']} rounds={res['rounds']} "
              f"locations={res['n_locations']} wall_s={wall}")
        print(f"  errors per round: {res['errors']}")
        print(f"  round wall seconds: {res['round_seconds']}")
        print(f"  fusion_stats: {stats}")
        print(f"  anen_distance launches: {anen_distance.launches - before}")
        check(res["all_done"], f"{method} all_done")
        check(res["rounds"] == MAIN["max_iters"], f"{method} rounds")
        check(all(math.isfinite(e) for e in res["errors"]),
              f"{method} finite errors")
        check(stats["fused"] > 0, f"{method} fused > 0")
        check(stats["scalar_fallback"] == 0, f"{method} scalar_fallback == 0")
        check(stats["degraded"] == 0, f"{method} degraded == 0")
        check(anen_distance.launches > before, f"{method} launched the kernel")
        runs[method] = {"wall_s": wall, "errors": res["errors"],
                        "round_seconds": res["round_seconds"],
                        "fusion_stats": stats}
    launches = anen_distance.launches
    shapes = dict(anen_distance.shapes)
    key = (MAIN["seed"], MAIN["ny"], MAIN["nx"], MAIN["n_hist"], "cuda:0")
    print(f"dataset build and upload seconds: {wf.DATASET_SECONDS.get(key)}")
    print(f"max_memory_allocated bytes: {torch.cuda.max_memory_allocated()}")
    print(f"main path anen_distance launches: {launches}, shapes: "
          f"{ {str(k): v for k, v in shapes.items()} }")
    return {"launches": launches, "shapes": shapes, "runs": runs}


def profile_main_path() -> None:
    """One more adaptive run of the main path under ``torch.profiler``:
    device time by kernel and the device's busy share of the wall time
    (profiler overhead included). Its launches are not counted: the
    main path's counts were read before."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.apps.anen.workflow import run_adaptive
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_adaptive(device="cuda", **MAIN)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(res["all_done"], "profiled run all_done")
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    print(f"profiled run_adaptive: wall_s={wall} device_busy_ms={busy_ms} "
          f"busy_share={busy_ms / 1e3 / wall} "
          f"round wall seconds={res['round_seconds']}")
    for key, count, ms in rows[:12] + [r for r in rows[12:]
                                       if "anen_distance" in r[0]]:
        print(f"  device {ms:.3f} ms  x{count}  {key[:90]}")


def cross_check() -> None:
    from repro_torch.apps.anen.workflow import run_adaptive
    on_gpu = run_adaptive(device="cuda", **SMALL)
    on_cpu = run_adaptive(device="cpu", **SMALL)
    diff = max(abs(a - b) for a, b in zip(on_gpu["errors"], on_cpu["errors"]))
    print(f"cross-check errors cuda={on_gpu['errors']} cpu={on_cpu['errors']} "
          f"max abs diff={diff}")
    check(on_gpu["all_done"] and on_cpu["all_done"], "cross-check all_done")
    check(len(on_gpu["errors"]) == len(on_cpu["errors"]) == SMALL["max_iters"],
          "cross-check rounds")
    # the tolerance of the JAX package's fused-vs-scalar AnEn check
    check(diff <= 1e-5, f"cuda vs cpu errors within 1e-5 (got {diff})")


def main() -> None:
    sys.path.insert(0, SRC)
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    import repro_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    build_s = build_kernels()
    print(f"kernel build seconds: {build_s}")

    equal = [compare_distance(s) for s in EQUAL_SHAPES]
    for row in [time_distance(s) for s in TIMED_SHAPES]:
        print(f"anen_distance {row}")

    main_path = run_main_path()
    # time the kernel at the shape the main path launched it at most
    main_shape = max(main_path["shapes"], key=main_path["shapes"].get)
    equal.append(compare_distance(main_shape))
    at_main = time_distance(main_shape)
    print(f"anen_distance at main-path shape {at_main}")

    cross_check()
    profile_main_path()

    record = {"kernels": [{
        "name": "anen_distance",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/anen_distance.cu",
        "replaces": "src/repro/kernels/anen_distance.py:81",
        "launches": main_path["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in equal),
        "ms": at_main["ms"],
        "plain_ms": at_main["plain_ms"],
        "call_ms": at_main["call_ms"],
        "bound_ms": at_main["bound_ms"],
        "bound_by": at_main["bound_by"],
        "library_ms": None,
        "shape": at_main["shape"],
    }]}
    print(card_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
