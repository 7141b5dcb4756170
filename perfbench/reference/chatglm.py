"""Plain float32 ChatGLM3 (the GLM family, arXiv:2406.12793; the published
``THUDM/chatglm3-6b`` modelling code) forward pass in PyTorch, written from
the equations, with no kernel, no cache and no batching trick of the
program under test.

A pre-norm decoder: RMSNorm; attention with ``multi_query_group_num`` key
and value heads shared by groups of query heads, rotary position on the
first half of each head's channels (base 10000 times ``rope_ratio``); a
SwiGLU MLP (silu(x W_g) * (x W_u)) W_d; a final RMSNorm and an untied
output layer.

It computes the variant the program implements and departs from the
published model where that does (``perfbench/configs/chatglm3-6b.json``
lists each): no bias on the query, key and value projections, and the
rotary half's channel i paired with channel i + hd/4 (rotate-half) where
the published code pairs 2i with 2i + 1, the same rotation of q and k
channels in another order.

``rnd`` is the rounding the control computes in: ``None`` for the
reference itself, or a function applied to both operands of every linear
layer (the projections, the MLP and the output layer).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]
ROPE_BASE = 10000.0


def vocab_size(cfg: dict) -> int:
    return cfg["padded_vocab_size"]


def _sizes(cfg: dict) -> Tuple[int, ...]:
    return (cfg["num_layers"], cfg["hidden_size"], cfg["ffn_hidden_size"],
            cfg["padded_vocab_size"], cfg["num_attention_heads"],
            cfg["multi_query_group_num"], cfg["kv_channels"])


# --------------------------------------------------------------------------- #
# Parameters: layout and initialisation
# --------------------------------------------------------------------------- #

def param_spec(cfg: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                        str, tuple, bool]]:
    """(path, shape, init, init args, matmul weight) for every leaf, in the
    program's layout (per-layer leaves stacked on a leading axis): matmul
    weights N(0, 1/fan_in), the embedding N(0, 1/hidden), the norms' scales
    uniform in [0.5, 1.5)."""
    L, D, F_, V, H, G, hd = _sizes(cfg)

    def mat(fan_in):
        return ("normal", (1.0 / math.sqrt(fan_in),))
    scale = ("uniform", (0.5, 1.5))
    return [
        (("embed",), (V, D), *mat(D), True),
        (("final_norm",), (D,), *scale, False),
        (("lm_head",), (D, V), *mat(D), True),
        (("blocks", "norms", "ln1"), (L, D), *scale, False),
        (("blocks", "norms", "ln2"), (L, D), *scale, False),
        (("blocks", "attn", "wq"), (L, D, H * hd), *mat(D), True),
        (("blocks", "attn", "wk"), (L, D, G * hd), *mat(D), True),
        (("blocks", "attn", "wv"), (L, D, G * hd), *mat(D), True),
        (("blocks", "attn", "wo"), (L, H * hd, D), *mat(H * hd), True),
        (("blocks", "mlp", "wu"), (L, D, F_), *mat(D), True),
        (("blocks", "mlp", "wd"), (L, F_, D), *mat(F_), True),
        (("blocks", "mlp", "wg"), (L, D, F_), *mat(D), True),
    ]


def program_sizes(port) -> Dict:
    """The program's model config (its ``ModelConfig``, passed in) as the
    configuration file's keys. Raises where the program's equations are
    not the ones computed here."""
    same = (port.family == "dense" and port.rope_variant == "2d"
            and port.rope_theta == ROPE_BASE and port.act == "silu"
            and port.mlp_gated and not port.tie_embeddings
            and not port.embedding_inputs and not port.n_experts)
    if not same:
        raise ValueError(f"the program's {port.name} is not the decoder "
                         f"this reference computes: {port}")
    return {"num_layers": port.n_layers, "hidden_size": port.d_model,
            "ffn_hidden_size": port.d_ff,
            "padded_vocab_size": port.vocab_size,
            "num_attention_heads": port.n_heads,
            "multi_query_group_num": port.n_kv_heads,
            "kv_channels": port.resolved_head_dim,
            "layernorm_epsilon": port.norm_eps}


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #

def _mm(a: torch.Tensor, b: torch.Tensor, rnd: Round) -> torch.Tensor:
    return a @ b if rnd is None else rnd(a) @ rnd(b)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, base: float) -> torch.Tensor:
    """x (B, S, heads, hd) at positions 0..S-1: the first hd/2 channels
    rotated, channel i with channel i + hd/4 by the angle pos * base **
    (-i / (hd/4)); the other half passes."""
    S, hd = x.shape[1], x.shape[-1]
    quarter = hd // 4
    freqs = base ** (-torch.arange(quarter, dtype=torch.float32,
                                   device=x.device) / quarter)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b, rest = x[..., :quarter], x[..., quarter:2 * quarter], \
        x[..., 2 * quarter:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, rest], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal softmax attention over (B, S, H, hd), k and v with G heads
    each shared by H / G query heads."""
    B, S, H, hd = q.shape
    k = k.repeat_interleave(H // k.shape[2], dim=2)
    v = v.repeat_interleave(H // v.shape[2], dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


def layer(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
          rnd: Round = None) -> torch.Tensor:
    L, D, F_, V, H, G, hd = _sizes(cfg)
    B, S, _ = x.shape
    eps = cfg["layernorm_epsilon"]
    base = ROPE_BASE * cfg.get("rope_ratio", 1)
    h = rms_norm(x, p["ln1"], eps)
    q = rotary(_mm(h, p["wq"], rnd).view(B, S, H, hd), base)
    k = rotary(_mm(h, p["wk"], rnd).view(B, S, G, hd), base)
    v = _mm(h, p["wv"], rnd).view(B, S, G, hd)
    o = attention(q, k, v).reshape(B, S, H * hd)
    x = x + _mm(o, p["wo"], rnd)
    h = rms_norm(x, p["ln2"], eps)
    return x + _mm(F.silu(_mm(h, p["wg"], rnd)) * _mm(h, p["wu"], rnd),
                   p["wd"], rnd)


def last_logits(params: Dict, cfg: dict, ids: torch.Tensor,
                rnd: Round = None) -> torch.Tensor:
    """(B, vocab) float32 logits at the last position of each row of
    ``ids`` (B, S); the parameters are taken a layer at a time."""
    blocks = params["blocks"]
    x = params["embed"][ids.long()].float()
    for i in range(cfg["num_layers"]):
        p = {name: leaf[i].float() for group in blocks.values()
             for name, leaf in group.items()}
        x = layer(p, x, cfg, rnd)
    h = rms_norm(x[:, -1], params["final_norm"].float(),
                 cfg["layernorm_epsilon"])
    return _mm(h, params["lm_head"].float(), rnd)


# --------------------------------------------------------------------------- #
# Model FLOPs
# --------------------------------------------------------------------------- #

def matmul_params(cfg: dict) -> int:
    """Weights of the layer stack that multiply every token: the query,
    key, value and output projections and the three MLP matrices a layer.
    The embedding is a gather; the output layer is counted apart."""
    L, D, F_, V, H, G, hd = _sizes(cfg)
    return L * (2 * D * H * hd + 2 * D * G * hd + 3 * D * F_)


def forward_flops(cfg: dict, batch: int, seq: int, head_tokens: int
                  ) -> float:
    """Model FLOPs of one forward pass of ``batch`` x ``seq`` tokens, the
    output layer applied at ``head_tokens`` positions: 2 a multiply-add
    of every matmul weight and token, and a layer's causal attention, 2
    products of 2 hd FLOPs for each of the S (S + 1) / 2 (query, key)
    pairs of each row and query head."""
    L, D, F_, V, H, G, hd = _sizes(cfg)
    pairs = seq * (seq + 1) / 2
    return (2.0 * matmul_params(cfg) * batch * seq
            + L * batch * H * 4.0 * hd * pairs + 2.0 * D * V * head_tokens)
