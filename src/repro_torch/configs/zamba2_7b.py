"""zamba2-7b — Mamba2 backbone + one shared attention block. [arXiv:2411.15242]

81L d_model=3584 (Mamba2: d_inner=7168, 112 heads of 64, state N=64),
shared attn block 32H (kv=32 ⇒ MHA) with d_ff=14336 MLP, vocab=32000.

Structure (DESIGN.md §3): 13 groups of ``attn_every=6`` Mamba2 layers, each
group followed by one application of the *single shared* attention+MLP block
(parameters reused — the Zamba trick), then 3 trailing Mamba2 layers.
Simplifications vs. the published checkpoint, recorded in DESIGN.md: the
per-application LoRA adapters on the shared block and the concat-with-
embedding input to it are omitted (framework-irrelevant detail).
Sub-quadratic: runs long_500k (Mamba states are O(1); the shared-attention
KV cache has 13 application sites).
"""

from ..models.config import ModelConfig, register_arch

NAME = "zamba2-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME, family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
        rope_variant="standard",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke", family="hybrid",
        n_layers=7, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, attn_every=3,
        rope_variant="standard",
    )


register_arch(NAME, full, smoke)
