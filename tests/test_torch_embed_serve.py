"""The port's vlm (qwen2-vl-2b, M-RoPE) and audio (musicgen-medium,
non-gated gelu MLP) families against the JAX package at smoke size, on
precomputed bf16 embeddings through the step functions, as the JAX
package runs them; and ``ServeSession.generate`` handing an M-RoPE
configuration (B, 3, S) positions, as JAX's does. The cases and their
tolerances are in ``_torch_attn_stack.py``."""

import jax
import numpy as np
import pytest

import _torch_attn_stack as common
from repro.launch import serve as jserve
from repro.models.config import get_config as jconfig
from repro_torch.launch import serve
from repro_torch.models.config import get_config as tconfig
from repro_torch.models.convert import params_from_numpy

ARCHS = ["qwen2-vl-2b", "musicgen-medium"]
FULL_PARAMS = {"qwen2-vl-2b": 1_543_656_960, "musicgen-medium": 1_362_249_216}


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


def test_generate_passes_mrope_positions_like_jax(monkeypatch):
    """Both serve drivers on a text-only variant of the qwen2-vl smoke
    configuration (token ids, M-RoPE): each hands its prefill step the same
    (B, 3, S) positions, the arange of the prompt in all three streams."""
    def text_only(real):
        return lambda arch, smoke=False, **kw: real(
            arch, smoke, **kw).replace(embedding_inputs=False)

    monkeypatch.setattr(jserve, "get_config", text_only(jconfig))
    monkeypatch.setattr(serve, "get_config", text_only(tconfig))
    prompts = np.random.default_rng(4).integers(0, 512, (2, 12)).astype(
        np.int32)
    seen = {}

    def recording(name, step):
        def wrapped(params, batch):
            seen[name] = np.asarray(batch["positions"])
            return step(params, batch)
        return wrapped

    jsess = jserve.ServeSession("qwen2-vl-2b", smoke=True)
    jsess.prefill = recording("jax", jsess.prefill)
    jtoks = jsess.generate(prompts, 3)
    tsess = serve.ServeSession("qwen2-vl-2b", smoke=True, device="cpu",
                               params=params_from_numpy(jax.tree.map(
                                   np.asarray, jsess.params), "cpu"))
    tsess.prefill = recording("port", tsess.prefill)
    ttoks = tsess.generate(prompts, 3)
    assert seen["port"].shape == seen["jax"].shape == (2, 3, 12)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    np.testing.assert_array_equal(
        seen["port"], np.broadcast_to(np.arange(12), (2, 3, 12)))
    assert ttoks.shape == np.asarray(jtoks).shape == (2, 3)
    assert ((ttoks >= 0) & (ttoks < 512)).all()
