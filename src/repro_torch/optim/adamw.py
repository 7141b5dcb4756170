"""AdamW with decoupled weight decay, global-norm clipping, LR schedules.

The JAX package's formula, term for term, over nested dicts of tensors
(no ``torch.optim``: its formula and state layout differ, and the
checkpoint layout is shared with the JAX package). The state is a dict
matching the parameters: f32 moments ``m`` and ``v`` and the step as a 0-d
int32 tensor.

Unlike the JAX versions, :func:`adamw_update` writes the parameters, the
moments, the step and the (clipped) gradients in place, leaf by leaf, and
returns the same dicts (and :func:`clip_by_global_norm` scales the
gradients in place): a second copy of a full-width train state (16
bytes a parameter) would be avoidable device memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree: Any) -> List[torch.Tensor]:
    """A nested dict's tensors in sorted key order (``jax.tree.leaves``'
    order for a dict)."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]


def _zeros(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree, dtype=torch.float32)


def adamw_init(params: Any) -> Dict[str, Any]:
    leaf = leaves(params)[0]
    return {"m": _zeros(params), "v": _zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def warmup_cosine(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    t = ((step - cfg.warmup_steps)
         / max(1.0, cfg.total_steps - cfg.warmup_steps))
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns (the same grads, the norm before scaling)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any,
                 cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any], Dict]:
    """One AdamW step, in place: (params, opt_state, {"grad_norm", "lr"}),
    the first two the dicts that were given, updated."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt_state["step"]
    step.add_(1)
    lr = warmup_cosine(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        gf = g.float()
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        delta.add_(pf, alpha=cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(pf - delta)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
