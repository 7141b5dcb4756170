"""The causal flash attention forward on (B, S, H, hd), as the serve path
calls it: q, k, v read once and out written once in the input type, the
log-sum-exp written in f32; 2 products of 2 hd operations for each of the
S (S + 1) / 2 (query, key) pairs of each (b, h), at the tensor-core rate
of bf16 inputs."""

from perfbench.costs import BF16_FLOPS_PER_S, bound


def cost(shape, elem: int) -> dict:
    B, S, H, hd = shape
    bytes_ = 4 * B * S * H * hd * elem + 4 * B * S * H
    flops = 4.0 * B * H * hd * (S * (S + 1) / 2)
    return bound(bytes_, flops, BF16_FLOPS_PER_S)
