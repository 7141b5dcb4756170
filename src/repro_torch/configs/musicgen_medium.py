"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]
48L d_model=1536 24H (kv=24 ⇒ MHA) d_ff=6144 vocab=2048.

Modality frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed EnCodec frame embeddings (B, S, d_model); the backbone owns the
2048-way audio-token head. Adaptation note: the published model uses learned
absolute positions; we use RoPE uniformly (positional scheme is orthogonal
to the systems contribution — recorded in DESIGN.md).
"""

from ..models.config import ModelConfig, register_arch

NAME = "musicgen-medium"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab_size=2048,
        embedding_inputs=True, act="gelu", mlp_gated=False,
        rope_variant="standard",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=128,
        embedding_inputs=True, act="gelu", mlp_gated=False,
        rope_variant="standard",
    )


register_arch(NAME, full, smoke)
