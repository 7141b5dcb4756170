"""The model substrate of the port: the hybrid family (zamba2) end to end.

* :mod:`config` — ``ModelConfig`` + the architecture registry (``--arch``).
* :mod:`rope` / :mod:`attention` / :mod:`mlp` / :mod:`mamba2` — block
  implementations (pure functions over param dicts of tensors).
* :mod:`transformer` — model assembly (prefill, KV cache / recurrent-state
  decode).
* :mod:`steps` — ``prefill_step`` / ``decode_step`` builders.
* :mod:`convert` — the JAX package's parameters (as numpy) to tensors.
"""

from .config import ModelConfig, get_config, list_archs, SHAPES  # noqa: F401
