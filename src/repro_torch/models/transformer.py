"""Model assembly: init / prefill / decode of the hybrid (zamba2), SSM
(rwkv6) and attention-stack (dense, vlm, audio) families.

The JAX package's parameter layout is kept at every public function:
per-layer parameters stacked on a leading axis, ``x @ W`` with ``W`` shaped
(in, out), the same dict keys, activations (B, S, H, hd). Where JAX scans
over layers, the port runs a Python loop over the stacked slices.

Hybrid (zamba2): groups of ``attn_every`` Mamba2 layers, each followed by
one application of a single *shared* attention+MLP block (parameters
reused across all applications — the Zamba trick); trailing Mamba layers
after the last group. SSM (rwkv6): a uniform stack of RWKV-6 layers, each
carrying its token shifts and (H, N, N) WKV state. Attention stack (dense,
moe, vlm, audio): pre-norm attention + MLP layers; vlm and audio take
precomputed (B, S, d_model) embeddings, and qwen2-vl's M-RoPE takes (B, 3,
S) positions. With experts (moe) the stack is ``n_layers //
moe_layer_period`` groups of ``period - 1`` dense layers and one MoE layer
(:mod:`repro_torch.models.moe`), as llama4-maverick alternates them; the
MoE layers' load-balance losses are summed into the backbone's aux loss.

:func:`apply_backbone` runs the stack for training and for prefill. With
``cfg.remat == "full"`` and grad mode on, each layer (each attention-stack,
RWKV or Mamba-2 layer, and each application of zamba2's shared block) is
one ``torch.utils.checkpoint`` region, as JAX's ``jax.checkpoint`` of the
scanned layer.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from . import mamba2, moe, pspec_ctx, rwkv6
from .attention import attention, decode_attention, update_cache
from .config import ModelConfig
from .mlp import add_rms_norm, gated_mlp, init_gated_mlp, normal, rms_norm
from .pspec_ctx import constrain
from .rope import apply_rope, default_positions

COMPUTE_DTYPE = torch.bfloat16


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #

def _init_attn(gen, cfg: ModelConfig, dtype, device,
               n_layers: int = 0) -> Dict:
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    lead = (n_layers,) if n_layers else ()
    s = math.sqrt(1.0 / D)
    return {
        "wq": normal(lead + (D, Hq * hd), s, gen, device, dtype),
        "wk": normal(lead + (D, Hkv * hd), s, gen, device, dtype),
        "wv": normal(lead + (D, Hkv * hd), s, gen, device, dtype),
        "wo": normal(lead + (Hq * hd, D), math.sqrt(1.0 / (Hq * hd)), gen,
                     device, dtype),
    }


def _init_norms(cfg: ModelConfig, device, n_layers: int = 0) -> Dict:
    lead = (n_layers,) if n_layers else ()
    return {"ln1": torch.ones(lead + (cfg.d_model,), dtype=torch.float32,
                              device=device),
            "ln2": torch.ones(lead + (cfg.d_model,), dtype=torch.float32,
                              device=device)}


def _device(device: DeviceLike) -> torch.device:
    """``"meta"`` as itself (shapes and dtypes, nothing allocated), any
    other device through :func:`resolve_device`."""
    return (torch.device("meta") if str(device) == "meta"
            else resolve_device(device))


def init_params(cfg: ModelConfig, seed: int = 0,
                param_dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Dict:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    there (seeded with ``seed``): nothing is drawn on the host for a CUDA
    device. ``device="meta"`` gives shapes and dtypes without allocating.
    The values differ from the JAX package's for the same seed; tests
    carry JAX's parameters over with :mod:`repro_torch.models.convert`."""
    dev = _device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    D, V = cfg.d_model, cfg.vocab_size
    params: Dict[str, Any] = {}
    if not cfg.embedding_inputs:
        params["embed"] = normal((V, D), 1.0 / math.sqrt(D), gen, dev,
                                 param_dtype)
    params["final_norm"] = torch.ones(D, dtype=torch.float32, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), 1.0 / math.sqrt(D), gen, dev,
                                   param_dtype)
    if cfg.family == "ssm":
        params["blocks"] = rwkv6.init_rwkv_layer(gen, cfg, cfg.n_layers,
                                                 param_dtype, dev)
        return params
    if cfg.family == "hybrid":
        params["mamba"] = mamba2.init_mamba_layer(gen, cfg, cfg.n_layers,
                                                  param_dtype, dev)
        params["shared_attn"] = {
            **_init_norms(cfg, dev),
            "attn": _init_attn(gen, cfg, param_dtype, dev),
            "mlp": init_gated_mlp(gen, D, cfg.d_ff, param_dtype, dev,
                                  gated=cfg.mlp_gated),
        }
        return params
    # dense / moe / audio / vlm: the attention stack; with experts, G
    # groups of period - 1 dense layers and one MoE layer
    if cfg.n_experts:
        period = cfg.moe_layer_period
        G = cfg.n_layers // period
        blocks = {
            "norms": _init_norms(cfg, dev, G * period),
            "attn": _init_attn(gen, cfg, param_dtype, dev, G * period),
            "moe": moe.init_moe(gen, cfg, G, param_dtype, dev),
        }
        if period > 1:
            blocks["mlp"] = init_gated_mlp(gen, D, cfg.d_ff, param_dtype,
                                           dev, G * (period - 1),
                                           gated=cfg.mlp_gated)
        params["blocks"] = blocks
        return params
    L = cfg.n_layers
    params["blocks"] = {
        "norms": _init_norms(cfg, dev, L),
        "attn": _init_attn(gen, cfg, param_dtype, dev, L),
        "mlp": init_gated_mlp(gen, D, cfg.d_ff, param_dtype, dev, L,
                              gated=cfg.mlp_gated),
    }
    return params


def abstract_params(cfg: ModelConfig,
                    param_dtype: torch.dtype = torch.float32) -> Dict:
    """The parameters on the meta device: their structure, shapes and
    dtypes, allocated nowhere (the dry-run's input)."""
    return init_params(cfg, param_dtype=param_dtype, device="meta")


# matmul weights cast to bf16 for compute (mixed precision); norms, router,
# decays and other numerics-sensitive leaves stay fp32
_COMPUTE_CAST = frozenset({
    "embed", "lm_head", "wq", "wk", "wv", "wo", "wg", "wu", "wd",
    "wr", "ck", "cv", "cr", "wz", "wx", "wb", "wc", "wdt",
    "out_proj", "conv_w", "conv_b",
})


def cast_for_compute(params: Dict, _path: Tuple[str, ...] = ()) -> Dict:
    """fp32 master params → bf16 compute copies for the matmul weights
    (bf16 leaves are returned as they are, not copied).

    Under an activation context with parameter specs, each bf16 copy is
    held to its f32 master's sharding: the cast runs on-shard and the
    gather moves bf16 (half the FSDP bytes), as in the JAX package."""
    ctx = pspec_ctx.active()
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = cast_for_compute(leaf, _path + (name,))
        elif name in _COMPUTE_CAST and leaf.dtype == torch.float32:
            out[name] = leaf.to(COMPUTE_DTYPE)
            if ctx is not None:
                out[name] = pspec_ctx.constrain_to(
                    out[name],
                    ctx.param_spec(pspec_ctx.path_str(_path + (name,))))
        else:
            out[name] = leaf
    return out


def _named_leaves(tree: Dict, path: Tuple[str, ...] = ()):
    """(keys from the root, leaf) for every leaf of a nested dict."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _named_leaves(leaf, path + (key,))
        else:
            yield path + (key,), leaf


def _leaves(tree: Dict):
    return (leaf for _, leaf in _named_leaves(tree))


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the meta device: nothing is allocated. With
    ``active_only``, the expert matrices count at ``experts_per_token /
    n_experts``, as the JAX package counts them: every ``wg``/``wu``/``wd``
    under ``moe``, the shared expert's too (``ROADMAP.md`` C10)."""
    total = expert = 0
    for keys, leaf in _named_leaves(init_params(cfg, device="meta")):
        n = leaf.numel()
        total += n
        if "moe" in keys and any(k in ("wg", "wu", "wd") for k in keys):
            expert += n
    if not active_only or not cfg.n_experts:
        return total
    frac = cfg.experts_per_token / cfg.n_experts
    return int(total - expert + expert * frac)


# --------------------------------------------------------------------------- #
# Attention sub-block (the attention stack's layers, the hybrid's shared
# block)
# --------------------------------------------------------------------------- #

def _project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, S, Hq, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    q = constrain(q, "dp", None, "tp", None)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    return q, k, v


def _repeat_heads(a: torch.Tensor, r: int) -> torch.Tensor:
    return a.repeat_interleave(r, dim=2) if r > 1 else a


def attn_block(p: Dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, want_cache: bool
               ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Full-sequence attention. Returns (out, (k,v) for the cache or None)."""
    B, S, _ = x.shape
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, cfg, positions)
    if not want_cache:
        # training: the sequence gathered on the Hkv-head tensors before
        # the GQA repeat (JAX's C1b)
        k = constrain(k, "dp", None, None, None)
        v = constrain(v, "dp", None, None, None)
    # the gradient of the repeat goes back to its own layout (the kv
    # heads whole): its backward sums groups of heads, which a model-axis
    # shard of fewer kv heads than the axis cannot hold
    kr = constrain(_repeat_heads(k, Hq // Hkv).contiguous(),
                   "dp", None, "tp", None, pin_grad=False)
    vr = constrain(_repeat_heads(v, Hq // Hkv).contiguous(),
                   "dp", None, "tp", None, pin_grad=False)
    o = attention(q.contiguous(), kr, vr)
    out = o.reshape(B, S, Hq * cfg.resolved_head_dim) @ p["wo"]
    if want_cache:
        r = cfg.kv_repeat
        return out, (_repeat_heads(k, r).to(COMPUTE_DTYPE),
                     _repeat_heads(v, r).to(COMPUTE_DTYPE))
    return out, None


def attn_decode_block(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, length: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token attention against a cache. x: (B,1,D). The new k/v are
    written into the cache in place (:func:`update_cache`)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(p, x, cfg, positions)
    k = _repeat_heads(k, cfg.kv_repeat)
    v = _repeat_heads(v, cfg.kv_repeat)
    k_cache, v_cache = update_cache(k_cache, v_cache, k, v, length)
    o = decode_attention(q, k_cache, v_cache, length + 1)
    out = o.reshape(B, 1, cfg.n_heads * hd) @ p["wo"]
    return out, k_cache, v_cache


def _mlp_residual(mlp: Dict, ln2: torch.Tensor, x: torch.Tensor,
                  cfg: ModelConfig, attn_out: torch.Tensor) -> torch.Tensor:
    """The second half of a pre-norm layer: x + a, then + MLP(norm)."""
    x, h = _add_normed(x, attn_out, ln2, cfg)
    return x + _residual(gated_mlp(mlp, h, cfg), cfg)


def _residual(y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A sub-block's output as the residual stream lies under an
    activation context: batch on the data axes, the sequence on the model
    axis with ``cfg.sp`` (a reduce-scatter of the partial sums forward, an
    all-gather of the gradient backward, as sequence parallelism runs)."""
    return constrain(y, "dp", "tp" if cfg.sp else None, None,
                     pin_grad=False)


def _normed(x: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """The pre-norm of a sub-block's input, its sequence gathered under an
    activation context (the input of its projections: the all-gather
    GSPMD inserts after a sequence-parallel residual)."""
    return constrain(rms_norm(x, scale, cfg.norm_eps), "dp", None, None)


def _add_normed(x: torch.Tensor, attn_out: torch.Tensor,
                scale: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + a, the pre-norm of that sum as :func:`_normed` gives it): the
    residual add and the norm after it, one launch on the fused route."""
    x, h = add_rms_norm(x, _residual(attn_out, cfg), scale, cfg.norm_eps)
    return x, constrain(h, "dp", None, None)


def _layer(tree: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of a (nested) dict of stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(tree: Dict, n: int) -> list:
    """The ``n`` per-layer slices of a (nested) dict of stacked tensors,
    through one ``unbind`` a leaf: its backward stacks the layers'
    gradients once, where ``n`` index ops would each write a full-size
    gradient."""
    parts = {k: _layers(v, n) if isinstance(v, dict)
             else pspec_ctx.unstack(v) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _gathered(fn):
    """``fn`` with its first argument, a layer's parameters, gathered for
    compute (:func:`pspec_ctx.gather_for_compute`)."""
    def run(p, *args):
        return fn(pspec_ctx.gather_for_compute(p), *args)
    return run


def _run_layer(cfg: ModelConfig, fn, *args):
    """``fn(*args)``; under ``cfg.remat == "full"`` with grad mode on,
    checkpointed (its activations recomputed in the backward), so training
    keeps one layer's activations at a time. One layer a checkpoint, not
    JAX's nested group + layer layout: a step then launches each kernel of
    a layer exactly twice forward (the pass and its recomputation). Under
    an activation context the layer's parameters are gathered inside the
    region (FSDP)."""
    if pspec_ctx.active() is not None:
        fn = _gathered(fn)
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------------- #
# Backbone forward (training / prefill)
# --------------------------------------------------------------------------- #

def _stack(states) -> Dict:
    """Per-layer state dicts → one dict of tensors stacked on a layer
    axis."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def apply_backbone(params: Dict, cfg: ModelConfig, h: torch.Tensor,
                   positions: Optional[torch.Tensor],
                   want_cache: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Run the layer stack. h: (B,S,D) embeddings (compute dtype).

    Returns (hidden, aux loss (the MoE layers' summed load-balance loss; 0
    without experts), cache or None). The cache layout matches
    :func:`init_cache` without ``length``."""
    if cfg.family == "ssm":
        h, cache = _apply_rwkv(params, cfg, h, want_cache)
    elif cfg.family == "hybrid":
        h, cache = _apply_zamba(params, cfg, h, positions, want_cache)
    else:
        return _apply_attn_stack(params, cfg, h, positions, want_cache)
    return h, torch.zeros((), dtype=torch.float32, device=h.device), cache


def _apply_rwkv(params: Dict, cfg: ModelConfig, h: torch.Tensor,
                want_cache: bool):
    """The RWKV layer stack: (hidden, {"rwkv": stacked states} or None)."""
    state0 = rwkv6.init_state(cfg, h.shape[0], h.device)
    states = []
    for p in _layers(params["blocks"], cfg.n_layers):
        h, s_new = _run_layer(cfg, rwkv6.rwkv_block, p, h, cfg, state0)
        states.append(s_new)
    return h, ({"rwkv": _stack(states)} if want_cache else None)


def _shared_block(shared: Dict, h: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, want_cache: bool):
    """One application of zamba2's shared attention + MLP block."""
    a, kv = attn_block(shared["attn"], _normed(h, shared["ln1"], cfg), cfg,
                       positions, want_cache)
    return _mlp_residual(shared["mlp"], shared["ln2"], h, cfg, a), kv


def _apply_zamba(params: Dict, cfg: ModelConfig, h: torch.Tensor,
                 positions: torch.Tensor, want_cache: bool):
    """The hybrid stack: (hidden, {"mamba", "k", "v"} or None). Each Mamba
    layer and each application of the shared block is one checkpoint."""
    B = h.shape[0]
    E = cfg.attn_every
    shared = params["shared_attn"]
    state0 = mamba2.init_state(cfg, B, h.device)
    states, ks, vs = [], [], []
    for li, p in enumerate(_layers(params["mamba"], cfg.n_layers)):
        h, s_new = _run_layer(cfg, mamba2.mamba_block, p, h, cfg, state0)
        states.append(s_new)
        if (li + 1) % E == 0:      # end of a group; trailing layers pass
            h, kv = _run_layer(cfg, _shared_block, shared, h, cfg,
                               positions, want_cache)
            if want_cache:
                ks.append(kv[0])
                vs.append(kv[1])
    if not want_cache:
        return h, None
    return h, {"mamba": _stack(states), "k": torch.stack(ks),
               "v": torch.stack(vs)}


def _ffn_residual(p: Dict, h: torch.Tensor, cfg: ModelConfig,
                  attn_out: torch.Tensor):
    """The second half of an attention-stack layer: h + a, then + its MLP
    or MoE of the norm. Returns (out, the MoE's aux loss or None)."""
    if "moe" not in p:
        return _mlp_residual(p["mlp"], p["norms"]["ln2"], h, cfg,
                             attn_out), None
    h, normed = _add_normed(h, attn_out, p["norms"]["ln2"], cfg)
    m, aux = moe.moe_apply(p["moe"], normed, cfg)
    return h + _residual(m, cfg), aux


def _attn_layer(p: Dict, h: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, want_cache: bool):
    """One pre-norm attention + MLP (or MoE) layer of the attention stack:
    (out, kv or None, aux loss or None)."""
    h = constrain(h, "dp", "tp" if cfg.sp else None, None)
    a, kv = attn_block(p["attn"], _normed(h, p["norms"]["ln1"], cfg),
                       cfg, positions, want_cache)
    h, aux = _ffn_residual(p, h, cfg, a)
    return h, kv, aux


def _stack_layers(blocks: Dict, cfg: ModelConfig) -> list:
    """Each layer of the attention stack as its parameters' dict, with
    ``mlp`` or, for the last layer of each group of ``moe_layer_period``
    (with experts), ``moe``."""
    if not cfg.n_experts:
        return _layers(blocks, cfg.n_layers)
    period = cfg.moe_layer_period
    G = cfg.n_layers // period
    norms = _layers(blocks["norms"], G * period)
    attn = _layers(blocks["attn"], G * period)
    moes = _layers(blocks["moe"], G)
    mlps = _layers(blocks["mlp"], G * (period - 1)) if period > 1 else []
    out = []
    for li in range(G * period):
        g, i = divmod(li, period)
        ffn = ({"moe": moes[g]} if i == period - 1
               else {"mlp": mlps[g * (period - 1) + i]})
        out.append({"norms": norms[li], "attn": attn[li], **ffn})
    return out


def _apply_attn_stack(params: Dict, cfg: ModelConfig, h: torch.Tensor,
                      positions: torch.Tensor, want_cache: bool):
    """The attention stack: (hidden, summed MoE aux loss, {"k", "v"} of
    shape (L, B, S, Hkv * kv_repeat, hd) in the compute dtype, or None).
    Each layer is one checkpoint, the MoE layers too."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ks, vs = [], []
    for p in _stack_layers(params["blocks"], cfg):
        h, kv, a = _run_layer(cfg, _attn_layer, p, h, cfg, positions,
                              want_cache)
        if a is not None:
            aux = aux + a
        if want_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    if not want_cache:
        return h, aux, None
    return h, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}


# --------------------------------------------------------------------------- #
# Heads
# --------------------------------------------------------------------------- #

def embed_inputs(params: Dict, cfg: ModelConfig, inputs: torch.Tensor
                 ) -> torch.Tensor:
    if cfg.embedding_inputs:
        out = inputs.to(COMPUTE_DTYPE)
    else:
        out = params["embed"][inputs.long()].to(COMPUTE_DTYPE)
    return constrain(out, "dp", "tp" if cfg.sp else None, None)


def logits_head(params: Dict, cfg: ModelConfig, h: torch.Tensor
                ) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ w.to(h.dtype)).float()


# --------------------------------------------------------------------------- #
# Prefill / decode
# --------------------------------------------------------------------------- #

def prefill(params: Dict, cfg: ModelConfig, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """Returns (last-token logits (B, V) f32, cache)."""
    B, S = inputs.shape[:2]
    h = embed_inputs(params, cfg, inputs)
    if positions is None and cfg.family != "ssm":
        positions = default_positions(B, S, cfg, device=inputs.device)
    h, _aux, cache = apply_backbone(params, cfg, h, positions,
                                    want_cache=True)
    logits = logits_head(params, cfg, h[:, -1:])[:, 0]
    cache["length"] = S
    return logits, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict:
    """Decode cache of zeros and ``length`` (a Python int): the stacked
    RWKV states (ssm); the stacked Mamba states and the shared block's
    (G, B, max_len, Hkv * kv_repeat, hd) k/v (hybrid); or every layer's
    (L, B, max_len, Hkv * kv_repeat, hd) k/v (attention stack).
    ``device="meta"`` gives its shapes and dtypes only."""
    dev = _device(device)
    if cfg.family == "ssm":
        state = rwkv6.init_state(cfg, batch, dev)
        return {"length": 0,
                "rwkv": {k: v.new_zeros((cfg.n_layers, *v.shape))
                         for k, v in state.items()}}
    kv_shape = (cfg.n_layers, batch, max_len,
                cfg.n_kv_heads * cfg.kv_repeat, cfg.resolved_head_dim)
    cache: Dict[str, Any] = {"length": 0}
    if cfg.family == "hybrid":
        kv_shape = (cfg.n_layers // cfg.attn_every, *kv_shape[1:])
        state = mamba2.init_state(cfg, batch, dev)
        cache["mamba"] = {k: v.new_zeros((cfg.n_layers, *v.shape))
                          for k, v in state.items()}
    cache["k"] = torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev)
    cache["v"] = torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev)
    return cache


def decode(params: Dict, cfg: ModelConfig, token: torch.Tensor,
           cache: Dict, positions: Optional[torch.Tensor] = None):
    """One decode step. token: (B,1) ids or (B,1,D) embeddings.

    Returns (logits (B, V) f32, cache). The cache's tensors are updated in
    place (new k/v slot, new Mamba or RWKV states) and returned in a new
    dict with ``length + 1``. Default positions are ``length``, as (B, 3,
    1) for M-RoPE."""
    B = token.shape[0]
    length = cache["length"]
    h = embed_inputs(params, cfg, token)
    if cfg.family == "ssm":
        h = _decode_rwkv(params, cfg, h, cache["rwkv"])
    else:
        if positions is None:
            positions = torch.full((B, 1), length, dtype=torch.int32,
                                   device=token.device)
            if cfg.rope_variant == "mrope":
                positions = positions[:, None].expand(B, 3, 1)
        if cfg.family == "hybrid":
            h = _decode_zamba(params, cfg, h, positions, cache)
        else:
            h = _decode_attn_stack(params, cfg, h, positions, cache)
    logits = logits_head(params, cfg, h)[:, 0]
    return logits, {**cache, "length": length + 1}


def _copy_states(states: Dict, li: int, new: Dict) -> None:
    """Layer ``li``'s new states into the stacked cache, in place (bf16
    token shifts into f32 slots are exact)."""
    for key, val in new.items():
        states[key][li].copy_(val)


def _decode_rwkv(params, cfg, h, states):
    for li, p in enumerate(_layers(params["blocks"], cfg.n_layers)):
        h, s_new = pspec_ctx.run_local(
            lambda p_, h_, s_: rwkv6.rwkv_decode(p_, h_, cfg, s_), p, h,
            _layer(states, li))
        _copy_states(states, li, s_new)
    return h


def _decode_zamba(params, cfg, h, positions, cache):
    E = cfg.attn_every
    length = cache["length"]
    shared = params["shared_attn"]
    states = cache["mamba"]
    for li, p in enumerate(_layers(params["mamba"], cfg.n_layers)):
        h, s_new = pspec_ctx.run_local(
            lambda p_, h_, s_: mamba2.mamba_decode(p_, h_, cfg, s_), p, h,
            _layer(states, li))
        _copy_states(states, li, s_new)
        if (li + 1) % E == 0:
            gi = li // E
            a, _, _ = attn_decode_block(
                shared["attn"], rms_norm(h, shared["ln1"], cfg.norm_eps),
                cfg, positions, cache["k"][gi], cache["v"][gi], length)
            h = _mlp_residual(shared["mlp"], shared["ln2"], h, cfg, a)
    return h


def _decode_attn_stack(params, cfg, h, positions, cache):
    """One token through the attention stack, layer by layer, each writing
    its new k/v slot into its slice of the stacked cache in place. The MoE
    layers' aux losses are discarded, as in the JAX package."""
    length = cache["length"]
    for li, p in enumerate(_stack_layers(params["blocks"], cfg)):
        a, _, _ = attn_decode_block(
            p["attn"], rms_norm(h, p["norms"]["ln1"], cfg.norm_eps), cfg,
            positions, cache["k"][li], cache["v"][li], length)
        h, _aux = _ffn_residual(p, h, cfg, a)
    return h
