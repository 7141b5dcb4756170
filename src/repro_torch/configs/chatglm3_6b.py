"""chatglm3-6b — 2d RoPE, extreme GQA (kv=2). [arXiv:2406.12793; hf]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
``rope_variant='2d'``: rotary applied to the first half of each head dim
(the GLM convention); remaining channels carry no positional signal.
"""

from ..models.config import ModelConfig, register_arch

NAME = "chatglm3-6b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=65024,
        rope_variant="2d",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=352, vocab_size=512,
        rope_variant="2d",
    )


register_arch(NAME, full, smoke)
