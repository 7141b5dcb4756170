"""llama4-maverick-400b-a17b — 128-expert top-1 MoE with shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.

Reconciliation note (DESIGN.md §3): the 400B-total / 17B-active figures of
the model name require the published interleaving — MoE every *other* layer
(``moe_layer_period=2``) plus a shared expert on MoE layers; with all-layer
MoE the totals would be ≈790B. Early fusion is a modality-frontend property;
the text backbone below is what the assignment's shape set exercises.
"""

from ..models.config import ModelConfig, register_arch

NAME = "llama4-maverick-400b-a17b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        n_experts=128, experts_per_token=1, moe_layer_period=2,
        moe_shared_expert=True,
        rope_variant="standard", rope_theta=500000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="moe",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab_size=512,
        n_experts=8, experts_per_token=1, moe_layer_period=2,
        moe_shared_expert=True,
        rope_variant="standard",
    )


register_arch(NAME, full, smoke)
