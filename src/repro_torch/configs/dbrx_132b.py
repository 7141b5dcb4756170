"""dbrx-132b — fine-grained MoE, 16 experts top-4, all layers MoE.

[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352.
Analytic total ≈132B params, ≈36B active (top-4 of 16).
"""

from ..models.config import ModelConfig, register_arch

NAME = "dbrx-132b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab_size=100352,
        n_experts=16, experts_per_token=4, moe_layer_period=1,
        rope_variant="standard", rope_theta=500000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab_size=512,
        n_experts=4, experts_per_token=2, moe_layer_period=1,
        rope_variant="standard",
    )


register_arch(NAME, full, smoke)
