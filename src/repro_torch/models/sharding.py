"""Partition specs for parameters, optimizer state, batches and caches.

The JAX package's scheme (``models/sharding.py``), rule for rule, on mesh
axes (``pod``?, ``data``, ``model``):

* activations and batch: the batch dim over (``pod``, ``data``).
* TP over ``model``: attention q-heads (when divisible), FFN hidden, MoE
  expert dim, vocab dim.
* FSDP over ``data``: every weight's non-TP matrix dim is also sharded
  over ``data`` (ZeRO-3). Optimizer moments take the same specs.
* Decode caches: batch over the data axes (sequence instead when batch ==
  1, the long_500k cell), heads over ``model`` when the (replicated-)head
  count divides the axis, else the sequence.

Every rule is divisibility-guarded: a dim that does not divide its axis is
replicated, so the same code serves one device and 512.

A spec is a :class:`PSpec`, a tuple of per-dimension entries (``None``, an
axis name, or a tuple of names), which reads like JAX's
``PartitionSpec``. :func:`to_placements` turns one into DTensor
placements, one per mesh dimension. The rules read a mesh through
``mesh.shape`` and ``mesh.axis_names`` only
(:class:`repro_torch.launch.mesh.Mesh`, or any object with the two).
"""

from __future__ import annotations

import math
from math import gcd
from typing import Any, Dict, List, Optional

from . import transformer
from .config import ModelConfig, ShapeConfig
from .input_specs import cache_specs


class PSpec(tuple):
    """Per-dimension mesh axes of a tensor: ``PSpec("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


def _axsize(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _dp_size(mesh) -> int:
    return math.prod(_axsize(mesh, a) for a in ("pod", "data"))


def dp_axes(mesh):
    """The axes the batch dim is sharded over."""
    names = [n for n in ("pod", "data") if n in mesh.axis_names]
    if not names:
        return None
    return tuple(names) if len(names) > 1 else names[0]


def _div(n: int, size: int) -> bool:
    return size > 1 and n % size == 0


def _guard(n: int, axis: str, mesh) -> Optional[str]:
    return axis if _div(n, _axsize(mesh, axis)) else None


def kv_repeat_for(cfg: ModelConfig, mesh) -> int:
    """KV replication so the cache head axis divides TP (when q-heads do)."""
    tp = _axsize(mesh, "model")
    if tp <= 1 or cfg.n_kv_heads == 0:
        return 1
    if cfg.n_heads % tp:
        return 1  # attention is replicated over TP anyway
    return tp // gcd(cfg.n_kv_heads, tp)


def _map_with_path(fn, tree: Dict, path=()) -> Dict:
    return {k: (_map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


# --------------------------------------------------------------------------- #
# Parameter specs (path-based rules)
# --------------------------------------------------------------------------- #

def _attn_spec(name: str, cfg: ModelConfig, mesh, lead) -> PSpec:
    tp_ok = _div(cfg.n_heads, _axsize(mesh, "model"))
    fsdp = _guard(cfg.d_model, "data", mesh)
    if name == "wq":
        return PSpec(*lead, fsdp, "model" if tp_ok else None)
    if name in ("wk", "wv"):
        return PSpec(*lead, fsdp, None)   # kv projections stay replicated
    if name == "wo":
        return PSpec(*lead, "model" if tp_ok else None, fsdp)
    return PSpec(*lead, None)


def _mlp_spec(name: str, d_in: int, d_ff: int, mesh, lead) -> PSpec:
    fsdp = _guard(d_in, "data", mesh)
    tp = _guard(d_ff, "model", mesh)
    if name in ("wg", "wu", "ck"):
        return PSpec(*lead, fsdp, tp)
    if name in ("wd", "cv"):
        return PSpec(*lead, tp, fsdp)
    return PSpec(*lead, fsdp, None)


def _param_rule(cfg: ModelConfig, mesh, keys, shape) -> PSpec:
    name = keys[-1]
    nd = len(shape)
    rep = PSpec(*([None] * nd))
    lead = [None] * (nd - 2)  # stacked layer axes
    if name == "embed":
        return PSpec(_guard(cfg.vocab_size, "model", mesh),
                     _guard(cfg.d_model, "data", mesh))
    if name == "lm_head":
        return PSpec(_guard(cfg.d_model, "data", mesh),
                     _guard(cfg.vocab_size, "model", mesh))
    if name == "final_norm" or nd <= 1 + len(lead):
        return rep
    if "attn" in keys and name in ("wq", "wk", "wv", "wo"):
        return _attn_spec(name, cfg, mesh, lead)
    if "moe" in keys:
        ep = _guard(cfg.n_experts, "model", mesh)
        fsdp = _guard(cfg.d_model, "data", mesh)
        if name == "router":
            return PSpec(*lead, fsdp, None)
        if name in ("wg", "wu", "wd") and "shared" not in keys:
            # expert weights carry 3 trailing dims (E, in, out)
            lead3 = [None] * (nd - 3)
            if name == "wd":
                return PSpec(*lead3, ep, _guard(cfg.d_ff, "data", mesh),
                             None)
            return PSpec(*lead3, ep, fsdp, None)
        if name in ("wg", "wu", "wd"):
            return _mlp_spec(name, cfg.d_model, cfg.d_ff, mesh, lead)
    if name in ("wg", "wu", "wd", "ck", "cv"):
        return _mlp_spec(name, cfg.d_model, cfg.d_ff, mesh, lead)
    # rwkv time mix: replicated over TP, FSDP on the first matrix dim
    if name in ("wr", "cr", "maa_w1", "decay_w1"):
        return PSpec(*lead, _guard(cfg.d_model, "data", mesh), None)
    if name in ("maa_w2", "decay_w2"):
        return rep
    if name in ("wz", "wx"):
        return PSpec(*lead, _guard(cfg.d_model, "data", mesh),
                     _guard(cfg.d_inner, "model", mesh))
    if name in ("wb", "wc", "wdt"):
        return PSpec(*lead, _guard(cfg.d_model, "data", mesh), None)
    if name == "out_proj":
        return PSpec(*lead, _guard(cfg.d_inner, "model", mesh),
                     _guard(cfg.d_model, "data", mesh))
    if name in ("conv_w", "conv_b", "out_norm"):
        return rep
    # default for 2D+ weights: FSDP on dim -2
    return PSpec(*lead, _guard(shape[-2], "data", mesh), None)


def param_specs(cfg: ModelConfig, mesh) -> Dict:
    """PSpec dict matching :func:`transformer.init_params`'s output."""
    return _map_with_path(
        lambda keys, leaf: _param_rule(cfg, mesh, keys, tuple(leaf.shape)),
        transformer.abstract_params(cfg))


def train_state_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    p_specs = param_specs(cfg, mesh)
    return {"params": p_specs,
            "opt": {"m": p_specs, "v": p_specs, "step": PSpec()}}


# --------------------------------------------------------------------------- #
# Batch / cache / token specs
# --------------------------------------------------------------------------- #

def _batch_axis(shape: ShapeConfig, mesh):
    return dp_axes(mesh) if _div(shape.global_batch, _dp_size(mesh)) \
        else None


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh
                 ) -> Dict[str, PSpec]:
    b_ax = _batch_axis(shape, mesh)
    out = {"inputs": (PSpec(b_ax, None, None) if cfg.embedding_inputs
                      else PSpec(b_ax, None))}
    if shape.kind == "train":
        out["labels"] = PSpec(b_ax, None)
    if cfg.rope_variant == "mrope":
        out["positions"] = PSpec(b_ax, None, None)
    return out


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict:
    """Specs matching :func:`transformer.init_cache`'s dict (``length``
    gets ``PSpec()``)."""
    dp = dp_axes(mesh)
    dp_size = _dp_size(mesh)
    batch_ok = _div(shape.global_batch, dp_size)
    tree = cache_specs(cfg, shape.global_batch, shape.seq_len)
    heff = cfg.n_kv_heads * cfg.kv_repeat
    tp_heads = _div(heff, _axsize(mesh, "model"))
    tp = _axsize(mesh, "model")

    def rule(keys, leaf) -> PSpec:
        name = keys[-1]
        if name == "length":
            return PSpec()
        shp = tuple(leaf.shape)
        nd = len(shp)
        if name in ("k", "v"):
            # (L|G, B, S, H, hd): batch over dp; heads over model when the
            # (replicated-)head count divides, else the model axis shards
            # the sequence; when batch cannot shard (long_500k) the dp
            # axes shard the sequence
            seq_ax: Any = None
            if not batch_ok and _div(shp[2], dp_size):
                seq_ax = dp
            elif not tp_heads and _div(shp[2], tp):
                seq_ax = "model"
            return PSpec(None, dp if batch_ok else None, seq_ax,
                         "model" if tp_heads else None, None)
        if "rwkv" in keys or "mamba" in keys:
            # states (L, B, ...): batch over dp; heads over model
            spec: List[Any] = ([None, dp if batch_ok else None]
                               + [None] * (nd - 2))
            if name in ("ssm", "wkv") and _div(shp[2], tp):
                spec[2] = "model"
            if name == "conv" and _div(shp[-1], tp):
                spec[-1] = "model"
            return PSpec(*spec)
        return PSpec(*([None] * nd))

    return _map_with_path(rule, tree)


def token_pspec(cfg: ModelConfig, shape: ShapeConfig, mesh) -> PSpec:
    b_ax = _batch_axis(shape, mesh)
    return (PSpec(b_ax, None, None) if cfg.embedding_inputs
            else PSpec(b_ax, None))


# --------------------------------------------------------------------------- #
# DTensor placements
# --------------------------------------------------------------------------- #

def to_placements(spec: PSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension
    in ``mesh.axis_names`` order: ``Shard(i)`` where the axis shards
    tensor dim ``i``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is None:
                continue
            if name in dim_of or name not in mesh.axis_names:
                raise ValueError(f"{spec!r}: axis {name!r} twice or not "
                                 f"in {mesh.axis_names}")
            dim_of[name] = i
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in mesh.axis_names)


def named(mesh, tree: Any) -> Any:
    """:func:`to_placements` over a (nested) dict of PSpecs."""
    if isinstance(tree, PSpec):
        return to_placements(tree, mesh)
    return {k: named(mesh, v) for k, v in tree.items()}
