"""stablelm-12b — dense GQA decoder. [hf:stabilityai/stablelm-2-1_6b; hf]

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""

from ..models.config import ModelConfig, register_arch

NAME = "stablelm-12b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13824, vocab_size=100352,
        rope_variant="standard",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=352, vocab_size=512,
        rope_variant="standard",
    )


register_arch(NAME, full, smoke)
