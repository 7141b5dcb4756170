"""Optimizer substrate: AdamW, clipping, schedules, and int8 gradient
compression with error feedback (:mod:`.compression`)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, warmup_cosine)
