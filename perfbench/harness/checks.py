"""The numbers that decide ``correct``, each from the program's output and
the plain reference's, and their limits (``perfbench/limits/<cell>.json``,
each set between the program's readings over many seeds and the control's;
``PERF.md`` gives both).

Serving: the widest gap by which a served token's logit lies below the
reference's best at its position, and the largest relative l2 distance of
the program's logits from the reference's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np


def load_limits(root: Path, workload: str) -> Dict[str, float]:
    return json.loads((root / "perfbench" / "limits" / f"{workload}.json")
                      .read_text())


def serve_readings(served: Sequence[int], prog_logits: np.ndarray,
                   ref_logits: np.ndarray) -> Dict[str, float]:
    """``served`` the token each request was answered with; the logits
    (requests, vocab) at the position it was served from."""
    ref = ref_logits.astype(np.float64)
    prog = prog_logits.astype(np.float64)
    rows = np.arange(len(served))
    gap = ref.max(axis=1) - ref[rows, np.asarray(served)]
    dist = (np.linalg.norm(prog - ref, axis=1)
            / np.linalg.norm(ref, axis=1))
    return {"token_gap": float(gap.max()), "logit_dist": float(dist.max())}


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> (bool, List[str]):
    """(every reading within its limit, one line a number)."""
    lines, ok = [], True
    for name in sorted(limits):
        value = readings.get(name, float("nan"))
        good = value <= limits[name]
        ok &= bool(good)
        lines.append(f"check {name} {value!r} limit {limits[name]!r} "
                     f"{'ok' if good else 'FAILED'}")
    return ok, lines
