"""The one traffic generator. A mix is a data file under
``perfbench/traffic/``; everything here is drawn from the run's seed.

Tokens follow a Zipf-like unigram law over the vocabulary with a Markov
overlay (with probability ``stay`` a token is its predecessor plus one), so
rows are neither uniform noise nor alike.

Prompt lengths are drawn log-uniform in strata: the ``strata`` quantiles
(j + 1/2) / strata of the law, rounded to ``len_step``, are one cycle of
lengths, which the seed shuffles anew each cycle. Every seed then sends the
same set of sizes, in another order.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np


def load(root: Path, name: str) -> Dict:
    return json.loads((root / "perfbench" / "traffic" / f"{name}.json")
                      .read_text())


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *keys])


class Tokens:
    """Rows of token ids for one vocabulary and token law."""

    def __init__(self, vocab: int, law: Dict) -> None:
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** -float(law["zipf"])
        self._cdf = np.cumsum(p / p.sum())
        self._cdf[-1] = 1.0
        self.vocab = vocab
        self.stay = float(law["stay"])

    def rows(self, seed: int, key: int, n: int, length: int) -> np.ndarray:
        """(n, length) int64 ids, a function of (seed, key) alone."""
        rng = _rng(seed, 0x70C, key)
        ids = np.searchsorted(self._cdf, rng.random((n, length)))
        stay = rng.random((n, length)) < self.stay
        stay[:, 0] = False
        # a run of stays continues from the last drawn token: t - start
        # steps on from ids[start], with start the run's first position
        pos = np.broadcast_to(np.arange(length), (n, length))
        start = np.maximum.accumulate(np.where(stay, 0, pos), axis=1)
        drawn = np.take_along_axis(ids, start, axis=1)
        return ((drawn + pos - start) % self.vocab).astype(np.int64)


def length_strata(mix: Dict) -> List[int]:
    """One cycle of prompt lengths (see the module's docstring)."""
    lo, hi, step, k = (mix["len_min"], mix["len_max"], mix["len_step"],
                       mix["strata"])
    out = []
    for j in range(k):
        x = math.exp(math.log(lo) + (j + 0.5) / k * (math.log(hi)
                                                     - math.log(lo)))
        out.append(int(min(hi, max(lo, step * round(x / step)))))
    return out


def prompt_length(mix: Dict, seed: int, index: int) -> int:
    strata = length_strata(mix)
    cycle, pos = divmod(index, len(strata))
    return strata[int(_rng(seed, 0x1E4, cycle).permutation(len(strata))[pos])]


def prompts(mix: Dict, tokens: Tokens, seed: int, index: int) -> np.ndarray:
    """Request batch ``index``: (batch, its length) prompt ids."""
    return tokens.rows(seed, 0x100000 + index, mix["batch"],
                       prompt_length(mix, seed, index))
