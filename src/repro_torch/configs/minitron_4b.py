"""minitron-4b — width/depth-pruned Nemotron. [arXiv:2407.14679; hf]

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
The 256k vocabulary makes this the embedding-dominated cell (vocab-sharding
stressor for the dry-run).
"""

from ..models.config import ModelConfig, register_arch

NAME = "minitron-4b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=9216, vocab_size=256000,
        rope_variant="standard",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=384, vocab_size=1024,
        rope_variant="standard",
    )


register_arch(NAME, full, smoke)
