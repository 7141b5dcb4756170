"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for. Everything a run uses is found by name from
``BENCHMARK.json``: the cell's configuration (``perfbench/configs/``) and
the plain reference it names (``perfbench/reference/``), its traffic mix
(``perfbench/traffic/``) and the driver of the mix's kind
(``perfbench/harness/<kind>_cell.py``), its limits (``perfbench/limits/``)
and a reader for each metric (``perfbench/metrics/<metric>.py``). The
run makes its weights and traffic from ``--seed``, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on
standard output; the numbers compared, each beside its limit, are the last
lines on standard error and the last key of that line.

With ``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` a profiled stretch of whole units runs before the window,
and the line carries the per-layer metrics, the device's busy and window
seconds and a breakdown of the trace.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the port's kernel library builds under the checkout's build/ directory;
# any other compiler cache goes beside it, at a fixed path
CACHE = ROOT / "build" / "perfbench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 1) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def manifest() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is the JAX
    stack's or the JAX package's, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Context:
    """What a cell's driver needs from the run."""

    def __init__(self, bench: Dict, workload: str, seed: int, seconds: float,
                 trace: bool, device: torch.device, smoke: bool = False,
                 config: Optional[Dict] = None, mix: Optional[Dict] = None,
                 cell: Optional[Dict] = None) -> None:
        cells = {c["name"]: c for c in bench["workloads"]}
        if cell is None and workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cell or cells[workload]
        if config is None:
            entry = next(c for c in bench["configs"]
                         if c["name"] == self.cell["config"])
            config = json.loads((ROOT / entry["file"]).read_text())
        self.config = config
        self.mix = mix or json.loads(
            (ROOT / "perfbench" / "traffic" / f"{self.cell['traffic']}.json")
            .read_text())
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.smoke = device, smoke

    def sync(self) -> None:
        """Wait for every card the run uses."""
        if self.device.type == "cuda":
            for i in range(self.cell["chips"]):
                torch.cuda.synchronize(i)

    def elapsed(self) -> float:
        return time.perf_counter() - T_START

    def memory_peak(self) -> int:
        """The peak of the fullest card the run uses."""
        if self.device.type != "cuda":
            return 0
        return max(int(torch.cuda.max_memory_allocated(i))
                   for i in range(self.cell["chips"]))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def load_reader(name: str):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: Dict, cell: str, bench: Dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return "workloads" not in moved or cell in moved["workloads"]


def metrics_of(bench: Dict, cell: str, trace: bool, run: Dict) -> Dict:
    group = bench["per_layer" if trace else "end_to_end"]
    out = {}
    for m in group:
        if trace and not _applies(m, cell, bench):
            continue
        if not trace and "workloads" in m and cell not in m["workloads"]:
            continue
        value = load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, **overrides) -> Dict:
    """Run one cell and return its result line (as a dict) and the lines of
    the numbers compared. ``overrides`` (tests only): ``smoke``,
    ``config``, ``mix``, ``cell``."""
    from perfbench.harness import checks
    bench = manifest()
    ctx = Context(bench, workload, seed, seconds, trace, device, **overrides)
    kind = ctx.mix["kind"]
    driver = importlib.import_module(f"perfbench.harness.{kind}_cell")
    run = driver.run(ctx)
    run.update(cell=ctx.cell, config=ctx.config, mix=ctx.mix, kind=kind)
    limits = checks.load_limits(ROOT, workload)
    correct, lines = checks.judge(run["readings"], limits)
    correct &= run["failed"] == 0
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": ctx.cell["chips"],
                   "memory_peak_bytes": run["memory_peak_bytes"]}
    line = {"correct": bool(correct), "attempted": run["attempted"],
            "failed": run["failed"],
            "metrics": metrics_of(bench, workload, trace, run),
            "device": device_info}
    if trace and run["trace"] is not None:
        from perfbench.harness.trace import breakdown
        device_info["busy_s"] = run["trace"]["busy_s"]
        device_info["window_s"] = run["trace"]["window_s"]
        line["breakdown"] = breakdown(run["trace"])
    line["checks"] = {name: {"value": run["readings"].get(name),
                             "limit": lim} for name, lim in limits.items()}
    return {"line": line, "lines": lines, "run": run}


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); "
             f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
             f"device_count() is {torch.cuda.device_count()}", 3)
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        fail(f"repro_torch was loaded from {repro_torch.__file__}, not from "
             f"this checkout's src/")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device)
    bad = forbidden_modules()
    if bad:
        fail(f"modules of the JAX stack or the JAX package were loaded: "
             f"{bad}")
    print(f"card: {power_limit()}", file=sys.stderr)
    run = out["run"]
    print(f"set-up {run['setup_s']:.3f} s, window {run['window']['seconds']:.3f}"
          f" s over {run['window']['units']} units, reference "
          f"{run['reference_s']:.3f} s", file=sys.stderr)
    if "detail" in run:
        print(f"detail {json.dumps(run['detail'])}", file=sys.stderr)
    for text in out["lines"]:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)


if __name__ == "__main__":
    main()
