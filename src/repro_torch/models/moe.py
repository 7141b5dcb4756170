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

All T tokens dispatch as one group, except under an activation-sharding
context with more than one data shard (:func:`_dispatch_groups`, as in
the JAX package): there each data shard's tokens are one group, whose
dispatch and combine run on the shard's own tensors.

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

from . import pspec_ctx
from .config import ModelConfig
from .mlp import activate, gated_mlp, init_gated_mlp, normal
from .pspec_ctx import constrain

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


def _dispatch_groups(cfg: ModelConfig, T: int) -> int:
    """Dispatch-group count, as the JAX package's (its §Perf A1): under
    an activation context with more than one data shard and
    ``cfg.moe_block_dispatch``, one group a data shard, so that the sort
    and the gathers stay on the shard and only the (G, E, C, D) capacity
    buffers cross to the experts' sharding; else 1. Capacity is per
    group."""
    if not cfg.moe_block_dispatch:
        return 1
    ctx = pspec_ctx.active()
    if ctx is None:
        return 1
    g = ctx.dp_size
    return g if (g > 1 and T % g == 0) else 1


def _dispatch(xg: torch.Tensor, eg: torch.Tensor, E: int, C: int):
    """Each group's sort-based capacity dispatch. xg (G, Tg, D), eg (G,
    Tg, K) → (buffers (G, E, C, D), the sorted experts and their order
    (G, Tg·K), each segment's start (G, E))."""
    G, Tg, D = xg.shape
    N = Tg * eg.shape[-1]
    dev = xg.device
    # stable: within an expert the earlier (token, choice) pairs keep the
    # capacity slots, as jnp.argsort does
    se, order = torch.sort(eg.reshape(G, N), dim=-1, stable=True)
    stok = torch.div(order, eg.shape[-1], rounding_mode="floor")
    eids = torch.arange(E, device=dev).expand(G, E).contiguous()
    start = torch.searchsorted(se, eids)                  # (G, E)
    end = torch.searchsorted(se, eids, right=True)
    # slot (e, c) holds the segment's c-th pair, or zeros past its end
    src = start[..., None] + torch.arange(C, device=dev)  # (G, E, C)
    filled = (src < end[..., None]).to(xg.dtype)
    tok = torch.gather(stok, 1, src.clamp(max=N - 1).reshape(G, E * C))
    rows = torch.arange(G, device=dev)[:, None]
    buf = xg[rows, tok].reshape(G, E, C, D) * filled[..., None]
    return buf, se, order, start


def _combine(y: torch.Tensor, eg: torch.Tensor, gg: torch.Tensor,
             se: torch.Tensor, order: torch.Tensor, start: torch.Tensor,
             C: int) -> torch.Tensor:
    """Each group's tokens read their K expert outputs from their slots
    of y (G, E·C, D) and sum them over K in f32 → (G, Tg, D) f32."""
    G, Tg, K = eg.shape
    N = Tg * K
    dev = y.device
    # each pair's position in its expert's segment, back in (Tg, K) order
    pos = torch.empty_like(se).scatter_(
        1, order, torch.arange(N, device=dev).expand(G, N)
        - torch.gather(start, 1, se))
    pos = pos.reshape(G, Tg, K)
    keep = pos < C
    slot = eg * C + pos.clamp(max=C - 1)
    rows = torch.arange(G, device=dev)[:, None, None]
    # the product in the compute dtype, the sum over K in f32, then the
    # cast: where JAX rounds
    contrib = y[rows, slot] * (gg * keep.to(gg.dtype))[..., None]
    out = torch.zeros((G, Tg, y.shape[-1]), dtype=torch.float32,
                      device=dev)
    for k in range(K):
        out = out + contrib[:, :, k].float()
    return out


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN. x: (B, S, D) → ((B, S, D), aux_loss)."""
    B, S, D = x.shape
    T = B * S
    E = cfg.n_experts
    G = _dispatch_groups(cfg, T)
    Tg = T // G
    C = capacity(Tg, cfg)
    x2d = x.reshape(T, D)
    cut = G > 1 and B % G != 0 and pspec_ctx.is_dtensor(x2d)
    if cut:
        # the groups cut batch rows: the (T, D) view's gradient, sharded
        # by group, must come back whole for the (B, S, D) view's backward
        x2d = constrain(x2d, None, None)

    with record_function("moe_route"):
        gates, experts, aux = _route(x2d, params["router"], cfg)

    # ---- sort-based capacity dispatch, per dispatch group --------------- #
    with record_function("moe_dispatch"):
        xg = constrain(x2d.reshape(G, Tg, D), "dp", None, None)
        eg = constrain(experts.reshape(G, Tg, -1), "dp", None, None)
        gg = constrain(gates.reshape(G, Tg, -1), "dp", None, None)
        grp = ("dp",) if G > 1 else (None,)     # groups on the data shards
        buf, se, order, start = pspec_ctx.local(
            lambda a, b: _dispatch(a, b, E, C),
            in_specs=[grp] * 2, out_specs=[grp] * 4)(xg, eg)
        # JAX pins (None, "tp"): GSPMD may then split the experts'
        # contraction over the data axes; DTensor would run every group on
        # every data shard (32x the expert FLOPs a device on dbrx-132b
        # train_4k), so the groups stay on their data shards
        buf = constrain(buf, "dp", "tp", None, None)

    # ---- expert FFNs (batched over the expert axis, all groups) --------- #
    with record_function("moe_experts"):
        be = buf.transpose(0, 1).reshape(E, G * C, D)
        h = (activate(torch.bmm(be, params["wg"]), cfg.act)
             * torch.bmm(be, params["wu"]))
        y = torch.bmm(h, params["wd"]).reshape(E, G, C, D).transpose(0, 1)
        y = constrain(y, "dp", "tp", None, None)

    # ---- combine, per group --------------------------------------------- #
    with record_function("moe_combine"):
        out = pspec_ctx.local(
            lambda yy, *m: _combine(yy.reshape(yy.shape[0], E * C, D), *m,
                                    C),
            in_specs=[grp] * 6, out_specs=grp)(y, eg, gg, se, order, start)
        out = constrain(out, "dp", None, None).reshape(T, D).to(x.dtype)

    if cfg.moe_shared_expert:
        with record_function("moe_shared"):
            out = out + gated_mlp(params["shared"], x2d, cfg)
    if cut:
        # the (B, S, D) view needs the batch rows whole
        out = constrain(out, None, None)
    return out.reshape(B, S, D), aux
