"""The model substrate of the port: every family, end to end (hybrid, ssm,
dense, moe, vlm, audio).

* :mod:`config` — ``ModelConfig`` + the architecture registry (``--arch``).
* :mod:`rope` / :mod:`attention` / :mod:`mlp` / :mod:`mamba2` /
  :mod:`rwkv6` / :mod:`moe` — block implementations (pure functions over
  param dicts of tensors).
* :mod:`transformer` — model assembly (the backbone with per-layer remat
  for training, prefill, KV cache / recurrent-state decode).
* :mod:`steps` — ``train_step`` (chunked CE, AdamW in place) /
  ``prefill_step`` / ``decode_step`` builders.
* :mod:`convert` — the JAX package's parameters and train state (as
  numpy) to tensors.
"""

from .config import ModelConfig, get_config, list_archs, SHAPES  # noqa: F401
