"""qwen2-vl-2b — M-RoPE, dynamic-resolution VLM backbone. [arXiv:2409.12191]

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

Vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch/text embeddings (B, S, d_model) and (B, 3, S) M-RoPE
position ids (temporal/height/width streams).
TP note (DESIGN.md §5): 12 heads are not divisible by the 16-way model
axis, so attention weights are replicated over TP (MLP + vocab sharded);
at 2B scale attention is a small FLOP fraction.
"""

from ..models.config import ModelConfig, register_arch

NAME = "qwen2-vl-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, head_dim=128,
        embedding_inputs=True,
        rope_variant="mrope", rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="vlm",
        n_layers=2, d_model=96, n_heads=4, n_kv_heads=2,
        d_ff=288, vocab_size=512, head_dim=24,
        embedding_inputs=True,
        rope_variant="mrope",
    )


register_arch(NAME, full, smoke)
