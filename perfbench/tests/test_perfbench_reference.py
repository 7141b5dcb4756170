"""The plain reference against the port, at smoke size on seeded weights,
both in float32: the reference computes the function the program
computes. And its parts against their definitions, in float64."""

import math

import pytest
import torch

from perfbench import reference
from perfbench.harness import traffic, weights
from perfbench.reference import chatglm as ref
from perfbench.tests import cases


@pytest.fixture()
def f32_port(monkeypatch):
    from repro_torch.models import transformer
    from repro_torch.models.config import get_config
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    return get_config("chatglm3-6b", smoke=True)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_prefill_logits_match_the_port(f32_port, index):
    from repro_torch.models import transformer
    cfg, mix = cases.config(), cases.mix()
    params = weights.make(ref.param_spec(cfg), cases.SEED, "cpu",
                          torch.float32)
    tokens = traffic.Tokens(ref.vocab_size(cfg), mix["tokens"])
    ids = torch.from_numpy(traffic.prompts(mix, tokens, cases.SEED, index))
    want = ref.last_logits(params, cfg, ids)
    got, _ = transformer.prefill(params, f32_port, ids.int())
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_the_program_sizes_are_the_files():
    from repro_torch.models.config import get_config
    cfg = cases.full_config()
    sizes = ref.program_sizes(get_config(cfg["arch"]))
    assert sizes == {k: cfg[k] for k in sizes}
    smoke = ref.program_sizes(get_config(cfg["arch"], smoke=True))
    assert smoke == {k: cases.config()[k] for k in smoke}


def test_another_decoder_is_refused():
    from repro_torch.models.config import get_config
    with pytest.raises(ValueError):
        ref.program_sizes(get_config("stablelm-12b"))


@pytest.mark.parametrize("hd", [8, 32, 128])
def test_rotary_turns_each_pair_by_its_angle(hd):
    g = torch.Generator().manual_seed(hd)
    x = torch.randn(1, 7, 3, hd, generator=g, dtype=torch.float64)
    out = ref.rotary(x, 10000.0)
    q = hd // 4
    for pos in range(7):
        for i in range(q):
            a = pos * 10000.0 ** (-i / q)
            c, s = math.cos(a), math.sin(a)
            x1, x2 = x[0, pos, :, i], x[0, pos, :, q + i]
            assert torch.allclose(out[0, pos, :, i], c * x1 - s * x2)
            assert torch.allclose(out[0, pos, :, q + i], c * x2 + s * x1)
    assert torch.equal(out[..., 2 * q:], x[..., 2 * q:])


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_attention_is_causal_softmax_over_shared_heads(groups):
    g = torch.Generator().manual_seed(groups)
    B, S, H, hd = 2, 9, 4, 16
    q = torch.randn(B, S, H, hd, generator=g, dtype=torch.float64)
    k, v = (torch.randn(B, S, groups, hd, generator=g, dtype=torch.float64)
            for _ in range(2))
    out = ref.attention(q, k, v)
    for h in range(H):
        kh, vh = k[:, :, h // (H // groups)], v[:, :, h // (H // groups)]
        want = torch.nn.functional.scaled_dot_product_attention(
            q[:, :, h].unsqueeze(1), kh.unsqueeze(1), vh.unsqueeze(1),
            is_causal=True)[:, 0]
        assert torch.allclose(out[:, :, h], want, rtol=1e-10, atol=1e-12)


def test_the_reference_is_found_by_the_files_name():
    assert reference.load(cases.full_config()["reference"]) is ref


def test_served_weights_are_drawn_in_their_type_and_again_alike():
    spec = ref.param_spec(cases.config())
    a = weights.make(spec, cases.SEED, "cpu", torch.bfloat16)
    b = weights.make(spec, cases.SEED, "cpu", torch.bfloat16)
    c = weights.make(spec, cases.SEED + 1, "cpu", torch.bfloat16)
    assert a["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert a["blocks"]["norms"]["ln1"].dtype == torch.float32
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert not torch.equal(a["lm_head"], c["lm_head"])
