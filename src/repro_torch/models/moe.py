"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

The JAX package's formulation, in plain PyTorch: a router in f32, a stable
sort of the (token, choice) pairs by expert, each expert's first ``C``
pairs in its (E, C, D) capacity buffer (the rest dropped), the grouped
expert FFN as batched matmuls over the expert axis, and the combine. JAX
runs this outside any Pallas kernel, as ``jnp`` under pjit; its one-hot
dispatch is avoided for the same reason as there (at E = 128 its T·E·C·D
FLOPs would dominate the expert compute).

Where JAX scatters, the port gathers, so that every value is computed in
one fixed order (the backward's index accumulations are PyTorch's
sort-based ones): a buffer slot reads the token sorted into it, and a
token reads its K expert outputs from their slots and sums them over K in
f32. A pure function of its inputs, bit for bit: the layer's recomputation
under remat equals its first pass.

All T tokens dispatch as one group. The JAX package's per-data-shard
groups (``cfg.moe_block_dispatch`` under an activation-sharding context)
wait for that context (``ROADMAP.md`` A12e).

Each part of the layer runs in a named profiler range (:data:`RANGES`),
so that a trace reads its device time by part; a range costs nothing
while no profiler is on.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .config import ModelConfig
from .mlp import activate, gated_mlp, init_gated_mlp, normal

# the profiler ranges of moe_apply, in the order they run
RANGES = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine",
          "moe_shared")


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert capacity, padded to a multiple of 8 lanes."""
    c = math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig, n_layers: int,
             dtype: torch.dtype, device: torch.device) -> Dict:
    """The router (f32), the experts' ``wg``/``wu`` (E, D, F) and ``wd``
    (E, F, D) in ``dtype``, and the shared expert's gated MLP, each behind
    a leading layer axis when ``n_layers`` > 0."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    lead = (n_layers,) if n_layers else ()
    s_r = math.sqrt(1.0 / D)
    s_in = math.sqrt(2.0 / (D + Fd))
    params = {
        "router": normal(lead + (D, E), s_r, gen, device, torch.float32),
        "wg": normal(lead + (E, D, Fd), s_in, gen, device, dtype),
        "wu": normal(lead + (E, D, Fd), s_in, gen, device, dtype),
        "wd": normal(lead + (E, Fd, D), s_in, gen, device, dtype),
    }
    if cfg.moe_shared_expert:
        params["shared"] = init_gated_mlp(gen, D, Fd, dtype, device,
                                          n_layers)
    return params


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (gates (T, K) in x's dtype, experts (T, K) int64, the Switch
    load-balance loss, an f32 scalar)."""
    logits = x2d.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                # (T, E)
    gates, experts = torch.topk(probs, cfg.experts_per_token, dim=-1)
    # renormalize the selected gates (standard for k>1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = cfg.n_experts
    me = probs.mean(dim=0)                                         # (E,)
    ce = F.one_hot(experts[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return gates.to(x2d.dtype), experts, aux


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN. x: (B, S, D) → ((B, S, D), aux_loss)."""
    B, S, D = x.shape
    T = B * S
    K = cfg.experts_per_token
    E = cfg.n_experts
    C = capacity(T, cfg)
    x2d = x.reshape(T, D)
    dev = x.device

    with record_function("moe_route"):
        gates, experts, aux = _route(x2d, params["router"], cfg)

    # ---- sort-based capacity dispatch ---------------------------------- #
    with record_function("moe_dispatch"):
        # stable: within an expert the earlier (token, choice) pairs keep
        # the capacity slots, as jnp.argsort does
        se, order = torch.sort(experts.reshape(T * K), stable=True)
        stok = torch.div(order, K, rounding_mode="floor")  # pair's token
        eids = torch.arange(E, device=dev)
        start = torch.searchsorted(se, eids)             # (E,) segment starts
        end = torch.searchsorted(se, eids, right=True)
        # slot (e, c) holds the segment's c-th pair, or zeros past its end
        src = start[:, None] + torch.arange(C, device=dev)[None, :]  # (E, C)
        filled = (src < end[:, None]).to(x.dtype)
        buf = (x2d[stok[src.clamp(max=T * K - 1)]]
               * filled[..., None])                                # (E, C, D)

    # ---- expert FFNs (batched over the expert axis) -------------------- #
    with record_function("moe_experts"):
        h = (activate(torch.bmm(buf, params["wg"]), cfg.act)
             * torch.bmm(buf, params["wu"]))
        y = torch.bmm(h, params["wd"]).reshape(E * C, D)

    # ---- combine ------------------------------------------------------- #
    with record_function("moe_combine"):
        # each pair's position in its expert's segment, back in (T, K) order
        pos = torch.empty_like(se).scatter_(
            0, order, torch.arange(T * K, device=dev) - start[se])
        pos = pos.reshape(T, K)
        keep = pos < C
        slot = experts * C + pos.clamp(max=C - 1)
        # the product in the compute dtype, the sum over K in f32, then the
        # cast: where JAX rounds
        contrib = (y[slot]
                   * (gates * keep.to(gates.dtype))[..., None])   # (T, K, D)
        out = torch.zeros((T, D), dtype=torch.float32, device=dev)
        for k in range(K):
            out = out + contrib[:, k].float()
        out = out.to(x.dtype)

    if cfg.moe_shared_expert:
        with record_function("moe_shared"):
            out = out + gated_mlp(params["shared"], x2d, cfg)
    return out.reshape(B, S, D), aux
