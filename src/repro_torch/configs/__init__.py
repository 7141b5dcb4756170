"""Assigned-architecture configs (one module per ``--arch`` id).

Importing a module registers its full + smoke configs with
:mod:`repro_torch.models.config`. ``repro_torch.models.config.get_config`` imports
lazily, so ``import repro_torch.configs`` is only needed to eagerly register all.
"""

from . import (dbrx_132b, llama4_maverick_400b_a17b, rwkv6_3b,  # noqa: F401
               musicgen_medium, stablelm_12b, minitron_4b,
               starcoder2_7b, chatglm3_6b, zamba2_7b, qwen2_vl_2b)
