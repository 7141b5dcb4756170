"""Meta-tensor stand-ins for every (arch × shape) dry-run cell.

``input_specs(cfg, shape)`` returns exactly the dicts the corresponding
step function consumes, as tensors on the meta device (shapes and dtypes,
nothing allocated), with the shapes and dtypes of the JAX package's
``ShapeDtypeStruct``s:

* train:   ``{"batch": {"inputs", "labels"[, "positions"]}}``
* prefill: ``{"batch": {"inputs"[, "positions"]}}``
* decode:  ``{"token", "cache"}``: one new token against a ``seq_len``
  cache.

Audio and VLM frontends are stubs: ``inputs`` are precomputed frame or
patch embeddings ``(B, S, d_model)`` bf16 instead of token ids.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import transformer
from .config import ModelConfig, ShapeConfig

META = torch.device("meta")


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _input_leaf(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.embedding_inputs:
        return _spec((batch, seq, cfg.d_model), torch.bfloat16)
    return _spec((batch, seq), torch.int32)


def _positions_leaf(cfg: ModelConfig, batch: int, seq: int
                    ) -> Optional[torch.Tensor]:
    if cfg.rope_variant == "mrope":
        return _spec((batch, 3, seq), torch.int32)
    return None  # default positions are generated inside the step


def batch_specs(cfg: ModelConfig, batch: int, seq: int, with_labels: bool
                ) -> Dict[str, Any]:
    out: Dict[str, Any] = {"inputs": _input_leaf(cfg, batch, seq)}
    if with_labels:
        out["labels"] = _spec((batch, seq), torch.int32)
    pos = _positions_leaf(cfg, batch, seq)
    if pos is not None:
        out["positions"] = pos
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """:func:`transformer.init_cache` on the meta device (``length`` stays
    the Python int 0)."""
    return transformer.init_cache(cfg, batch, max_len, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, B, S, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, B, S, with_labels=False)}
    if shape.kind == "decode":
        token = (_spec((B, 1, cfg.d_model), torch.bfloat16)
                 if cfg.embedding_inputs else _spec((B, 1), torch.int32))
        return {"token": token, "cache": cache_specs(cfg, B, S)}
    raise ValueError(f"unknown shape kind {shape.kind!r}")
