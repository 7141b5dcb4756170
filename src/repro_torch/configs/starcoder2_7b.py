"""starcoder2-7b — GQA + RoPE code model. [arXiv:2402.19173; hf]

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""

from ..models.config import ModelConfig, register_arch

NAME = "starcoder2-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18432, vocab_size=49152,
        act="gelu", mlp_gated=False, rope_variant="standard",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="dense",
        n_layers=2, d_model=144, n_heads=4, n_kv_heads=2,
        d_ff=576, vocab_size=512,
        act="gelu", mlp_gated=False, rope_variant="standard",
    )


register_arch(NAME, full, smoke)
