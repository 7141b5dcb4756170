"""Step builders: prefill / decode as plain functions over param dicts.

The train step (chunked cross-entropy, AdamW) waits for the training
slice (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import transformer
from .config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params: Dict, batch: Dict[str, torch.Tensor]):
        params = transformer.cast_for_compute(params)
        return transformer.prefill(params, cfg, batch["inputs"],
                                   batch.get("positions"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params: Dict, token: torch.Tensor, cache: Dict):
        params = transformer.cast_for_compute(params)
        return transformer.decode(params, cfg, token, cache)
    return decode_step
