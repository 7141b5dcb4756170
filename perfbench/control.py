"""The readings that set each limit's upper end: the plain reference put in
the program's place and computed one precision below the configuration's
bfloat16, in float8 (e4m3, one scale a tensor) on both operands of every
linear layer, against the float32 reference.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 [--cpu]

For each seed it prints one JSON line with the control's readings, by the
names the cell's check uses, over the requests a run of that seed checks
first: the first ``check_batches`` batches of the seed's traffic and the
longest prompt of a cycle. The greedy token read is the one the float8
forward puts first. The benchmark's own runs never run this;
``perfbench/tests`` runs it at a size a test can hold.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import reference  # noqa: E402
from perfbench.harness import checks, traffic, weights  # noqa: E402


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale a tensor (its largest magnitude
    to the format's largest), back in x's dtype."""
    top = torch.finfo(torch.float8_e4m3fn).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def check_indices(mix: Dict, seed: int) -> List[int]:
    """The batches the control reads: the first ``check_batches`` - 1 and
    the longest of the first cycle."""
    longest = max(range(len(traffic.length_strata(mix))),
                  key=lambda i: traffic.prompt_length(mix, seed, i))
    return sorted(set(range(mix["check_batches"] - 1)) | {longest})


def serve_control(cfg: Dict, mix: Dict, seed: int, device) -> Dict:
    """The control's readings of one seed."""
    ref = reference.load(cfg["reference"])
    params = weights.make(ref.param_spec(cfg), seed, device, torch.bfloat16)
    tokens = traffic.Tokens(ref.vocab_size(cfg), mix["tokens"])
    want, got = [], []
    for index in check_indices(mix, seed):
        ids = torch.from_numpy(traffic.prompts(mix, tokens, seed, index)
                               ).to(device)
        want.append(ref.last_logits(params, cfg, ids).cpu().numpy())
        got.append(ref.last_logits(params, cfg, ids, round_e4m3)
                   .cpu().numpy())
    del params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    logits = np.concatenate(got)
    return checks.serve_readings(logits.argmax(axis=1).tolist(), logits,
                                 np.concatenate(want))


def main(argv: List[str] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    mix = traffic.load(ROOT, cell["traffic"])
    device = torch.device("cpu" if args.cpu else "cuda")
    reference.exact_f32()
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = serve_control(cfg, mix, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "control_e4m3": out}), flush=True)


if __name__ == "__main__":
    main()
