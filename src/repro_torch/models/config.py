"""ModelConfig + architecture/shape registries (copy of the JAX package's).

Every assigned architecture lives in ``repro_torch/configs/<id>.py`` and
registers itself here via :func:`register_arch`. Each registration provides
the exact published configuration plus a reduced ``smoke`` variant of the
same family (small widths/layers/experts) for CPU tests. The port's model
runs every family: ``hybrid`` (zamba2-7b), ``ssm`` (rwkv6-3b), ``dense``
(chatglm3-6b, minitron-4b, stablelm-12b, starcoder2-7b), ``moe``
(dbrx-132b, llama4-maverick-400b-a17b), ``vlm`` (qwen2-vl-2b) and
``audio`` (musicgen-medium).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free architectures
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 ⇒ d_model // n_heads
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1       # every k-th layer is MoE (1 ⇒ all layers)
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0             # hybrid: shared attn block every k ssm layers
    # --- positions ----------------------------------------------------------
    rope_variant: str = "standard"  # standard | 2d | mrope | none
    rope_theta: float = 10000.0
    # --- modality frontend stub ----------------------------------------------
    embedding_inputs: bool = False  # audio/vlm: inputs are frame/patch embeddings
    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-5
    act: str = "silu"
    mlp_gated: bool = True          # SwiGLU-style; False ⇒ plain 2-matrix MLP
    tie_embeddings: bool = False
    remat: str = "full"             # full | none
    # decode-cache KV-head replication factor (chosen per mesh so the head
    # axis is TP-divisible; 1 on a single device). See DESIGN.md §5.
    kv_repeat: int = 1
    # sequence-parallel activations: layer-boundary (B, S, D) tensors (and
    # the remat stash, which dominates training memory) are sharded over the
    # model axis along S. Disable to reproduce the naive baseline of §Perf.
    sp: bool = True
    # §Perf optimizations (True = optimized; False = paper-faithful naive
    # baseline, kept lowerable for the before/after roofline record):
    # decode as an unrolled per-layer loop — a scanned decode carries the
    # full KV cache through the while-loop state, costing ~6× cache memory
    moe_block_dispatch: bool = True   # per-data-shard MoE dispatch groups
    # decode_unroll was REFUTED as an optimization (§Perf B1/B2): with the
    # seq-sharded cache the scanned decode aliases better than the unrolled
    # DUS chain (16.1 vs 22.7 GiB/dev, 0.79 vs 2.3 s memory term)
    decode_unroll: bool = False

    # -- derived -------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (paper-of-record: SSM/hybrid only)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Parameter count of the port's model, taken on the meta device
        (nothing is allocated)."""
        from . import transformer
        return transformer.count_params(self)

    def n_active_params(self) -> int:
        from . import transformer
        return transformer.count_params(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# ----------------------------------------------------------------------------- #
# Registry
# ----------------------------------------------------------------------------- #

_ARCHS: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKES: Dict[str, Callable[[], ModelConfig]] = {}

ARCH_IDS: Tuple[str, ...] = (
    "dbrx-132b",
    "llama4-maverick-400b-a17b",
    "rwkv6-3b",
    "musicgen-medium",
    "stablelm-12b",
    "minitron-4b",
    "starcoder2-7b",
    "chatglm3-6b",
    "zamba2-7b",
    "qwen2-vl-2b",
)

_MODULE_OF = {a: "repro_torch.configs." + a.replace("-", "_")
              for a in ARCH_IDS}


def register_arch(name: str, full: Callable[[], ModelConfig],
                  smoke: Callable[[], ModelConfig]) -> None:
    _ARCHS[name] = full
    _SMOKES[name] = smoke


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    if arch not in _ARCHS:
        if arch in _MODULE_OF:
            importlib.import_module(_MODULE_OF[arch])
        else:
            raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_OF)}")
    cfg = (_SMOKES if smoke else _ARCHS)[arch]()
    return cfg.replace(**overrides) if overrides else cfg


def list_archs() -> List[str]:
    return list(ARCH_IDS)



def cells(include_skipped: bool = False):
    """Yield (arch, shape, skip_reason|None) for the 40 assigned cells."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            skip: Optional[str] = None
            if shape_name == "long_500k" and not cfg.sub_quadratic:
                skip = ("full-attention architecture: no sub-quadratic path "
                        "at 524288 context")
            if skip is None or include_skipped:
                yield arch, shape, skip
