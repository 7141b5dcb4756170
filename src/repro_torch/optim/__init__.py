"""Optimizer substrate: AdamW, clipping, schedules. Gradient compression
(int8 with error feedback) waits for the data-parallel slice (ROADMAP.md
A12d)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, warmup_cosine)
