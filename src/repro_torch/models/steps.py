"""Step builders: train / prefill / decode as plain functions over param
dicts.

The train loss is a *chunked* cross-entropy: logits are produced and
reduced sequence chunk by chunk, each chunk one checkpoint region, so
neither the full (B, S, V) logits nor any (B, c, V) chunk of them is kept
for the backward. The train step takes gradients with
``torch.autograd.grad`` on the f32 master leaves (through the bf16 copies
of :func:`transformer.cast_for_compute`) and applies AdamW in place, leaf
by leaf: the returned state is the state it was given, updated (JAX
returns new arrays; the port saves the second copy of the train state).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update, leaves
from . import transformer
from .config import ModelConfig
from .mlp import rms_norm
from . import pspec_ctx
from .pspec_ctx import constrain, gather_for_compute
from .rope import default_positions

AUX_COEF = 0.01
CE_CHUNK = 512


def _ce_chunk(hx: torch.Tensor, w: torch.Tensor, lx: torch.Tensor
              ) -> torch.Tensor:
    logits = constrain((hx @ w).float(), "dp", None, "tp")
    if pspec_ctx.is_dtensor(logits):
        # vocab-parallel: the max and the sum of exponentials reduced over
        # the vocab shards, the gold logit from its own shard
        m = logits.detach().amax(-1, keepdim=True)
        logz = (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
                )[..., 0]
        return torch.sum(logz - pspec_ctx.vocab_gold(logits, lx))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lx.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def chunked_ce_loss(params: Dict, cfg: ModelConfig, hidden: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE over (B, S) from backbone hidden states; the
    chunk is the largest divisor of S up to ``CE_CHUNK``."""
    B, S, _ = hidden.shape
    c = min(CE_CHUNK, S)
    while S % c:
        c -= 1
    h = constrain(rms_norm(hidden, params["final_norm"], cfg.norm_eps),
                  "dp", None, None)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    w = gather_for_compute(w.to(h.dtype))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // c):
        hx, lx = h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            # without the checkpoint, autograd keeps each (B, c, V) logits
            # chunk for the backward: the full logits through the back door
            total = total + checkpoint(_ce_chunk, hx, w, lx,
                                       use_reentrant=False)
        else:
            total = total + _ce_chunk(hx, w, lx)
    return total / (B * S)


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    params = transformer.cast_for_compute(params)
    inputs = batch["inputs"]
    B, S = inputs.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(B, S, cfg, device=inputs.device)
    h = transformer.embed_inputs(params, cfg, inputs)
    h, aux, _ = transformer.apply_backbone(params, cfg, h, positions,
                                           want_cache=False)
    ce = chunked_ce_loss(params, cfg, h, batch["labels"])
    loss = ce + AUX_COEF * aux
    return loss, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------- #
# Train step
# --------------------------------------------------------------------------- #

def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """f32 master parameters drawn on ``device`` from ``seed`` and their
    AdamW state (``device="meta"`` gives shapes only)."""
    dev = "meta" if str(device) == "meta" else resolve_device(device)
    params = transformer.init_params(cfg, seed, torch.float32, dev)
    return {"params": params, "opt": adamw_init(params)}


def abstract_train_state(cfg: ModelConfig) -> Dict[str, Any]:
    """The train state's structure, shapes and dtypes, allocated nowhere."""
    return init_train_state(cfg, device="meta")


def unflatten(tree: Dict, flat: List[torch.Tensor]) -> Dict:
    """``flat`` (in :func:`~repro_torch.optim.adamw.leaves` order) in
    ``tree``'s structure."""
    it = iter(flat)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return build(tree)


def _grads(params: Dict, cfg: ModelConfig, batch: Dict,
           masters: List[torch.Tensor]):
    loss, metrics = loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, masters, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(masters, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt: Optional[AdamWConfig] = None,
                    accum_steps: int = 1):
    opt = opt or AdamWConfig()

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        masters = leaves(params)
        for p in masters:
            p.requires_grad_(True)
        try:
            if accum_steps == 1:
                loss, metrics, grads = _grads(params, cfg, batch, masters)
            else:
                # gradient accumulation over microbatches, in order
                n = next(iter(batch.values())).shape[0] // accum_steps
                grads, lsum = None, 0.0
                for i in range(accum_steps):
                    mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                    loss_i, _, g = _grads(params, cfg, mb, masters)
                    lsum = lsum + loss_i
                    grads = g if grads is None else [
                        a.add_(b) for a, b in zip(grads, g)]
                grads = [g.div_(accum_steps) for g in grads]
                loss = lsum / accum_steps
                metrics = {}
        finally:
            for p in masters:
                p.requires_grad_(False)
        opt_metrics = adamw_update(unflatten(params, grads), state["opt"],
                                   params, opt)[2]
        return state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


# --------------------------------------------------------------------------- #
# Serving steps
# --------------------------------------------------------------------------- #

def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params: Dict, batch: Dict[str, torch.Tensor]):
        params = transformer.cast_for_compute(params)
        return transformer.prefill(params, cfg, batch["inputs"],
                                   batch.get("positions"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params: Dict, token: torch.Tensor, cache: Dict):
        params = transformer.cast_for_compute(params)
        return transformer.decode(params, cfg, token, cache)
    return decode_step
