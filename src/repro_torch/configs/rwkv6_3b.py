"""rwkv6-3b — Finch: attention-free, data-dependent decay.

[arXiv:2404.05892; hf]
32L d_model=2560 (40 WKV heads of 64) d_ff=8960 vocab=65536.
Sub-quadratic: runs the long_500k cell with O(1) recurrent state.
"""

from ..models.config import ModelConfig, register_arch

NAME = "rwkv6-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="ssm",
        n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=8960, vocab_size=65536,
        rope_variant="none",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="ssm",
        n_layers=2, d_model=128, n_heads=0, n_kv_heads=0,
        d_ff=448, vocab_size=512,
        rope_variant="none",
    )


register_arch(NAME, full, smoke)
