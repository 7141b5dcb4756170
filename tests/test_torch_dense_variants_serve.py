"""The port's dense configurations with other position and MLP variants
against the JAX package at smoke size: chatglm3-6b (2d RoPE: half the head
dim turns) and starcoder2-7b (non-gated gelu MLP, head dim 36), and each
RoPE variant at its full-width head dim. The cases and their tolerances
are in ``_torch_attn_stack.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_attn_stack as common
from repro.models.config import get_config as jconfig
from repro.models.rope import apply_rope as japply_rope
from repro_torch.models.config import get_config as tconfig
from repro_torch.models.rope import apply_rope

ARCHS = ["chatglm3-6b", "starcoder2-7b"]
# the JAX package's count_params at the published widths
FULL_PARAMS = {"chatglm3-6b": 6_243_454_976, "starcoder2-7b": 7_399_051_776}


@pytest.mark.parametrize("jax_impl", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch, jax_impl):
    common.check_prefill(arch, jax_impl)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(arch):
    common.check_teacher_forced_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_and_chained_decode_match_jax(arch, monkeypatch):
    common.check_f32_prefill_and_chained_decode(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistent_with_prefill(arch):
    common.check_decode_consistent_with_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_at_full_width_allocates_nothing(arch):
    common.check_count_params(arch, FULL_PARAMS[arch])


@pytest.mark.parametrize("arch", ["stablelm-12b", "chatglm3-6b",
                                  "qwen2-vl-2b"])
def test_rope_matches_jax_at_full_head_dim(arch):
    """standard at hd 160, 2d at 128 and M-RoPE at 128 (sections 44, 42,
    42, each turned by its own random position stream), in f32."""
    cfg = tconfig(arch)
    hd = cfg.resolved_head_dim
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    shape = (2, 3, 7) if cfg.rope_variant == "mrope" else (2, 7)
    pos = rng.integers(0, 4096, shape).astype(np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), cfg)
    want = japply_rope(jnp.asarray(x), jnp.asarray(pos), jconfig(arch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
