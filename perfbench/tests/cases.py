"""Small configurations and mixes of the benchmark's cells, for tests on
the CPU: the same files, cut to the port's smoke model."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PREFILL = "chatglm3-6b.prefill"
SEED = 2 ** 31 + 977
# the port's chatglm3-6b smoke sizes, by the configuration file's keys
SMOKE = {"num_layers": 2, "hidden_size": 128, "ffn_hidden_size": 352,
         "kv_channels": 32, "num_attention_heads": 4,
         "multi_query_group_num": 2, "padded_vocab_size": 512}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(workload: str = PREFILL) -> dict:
    return next(c for c in bench()["workloads"] if c["name"] == workload)


def full_config(workload: str = PREFILL) -> dict:
    entry = next(c for c in bench()["configs"]
                 if c["name"] == cell(workload)["config"])
    return json.loads((ROOT / entry["file"]).read_text())


def config(workload: str = PREFILL) -> dict:
    """The cell's configuration file at the port's smoke sizes."""
    return {**full_config(workload), **SMOKE}


def mix(workload: str = PREFILL) -> dict:
    m = json.loads((ROOT / "perfbench/traffic" / f"{cell(workload)['traffic']}.json")
                   .read_text())
    m.update(len_min=64, len_max=192, strata=3, batch=2, trace_batches=2,
             check_batches=2)
    return m
