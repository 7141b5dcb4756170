"""The port's dense family (token inputs, standard RoPE, gated silu MLP)
against the JAX package at smoke size: minitron-4b and stablelm-12b, a
``kv_repeat`` cache, then serving through ``run_managed`` and the command
line. The cases and their
tolerances are in ``_torch_attn_stack.py``; chatglm3-6b and starcoder2-7b
are in ``test_torch_dense_variants_serve.py``."""

import sys

import numpy as np
import pytest

import _torch_attn_stack as common
from repro_torch.launch import serve
from repro_torch.models.config import get_config as tconfig

ARCHS = ["minitron-4b", "stablelm-12b"]
# the JAX package's count_params at the published widths
FULL_PARAMS = {"minitron-4b": 5_096_279_040, "stablelm-12b": 12_142_924_800}


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


def test_kv_repeat_matches_jax():
    """``kv_repeat=2`` on both sides: the cache holds each kv head twice
    (2 Hkv heads); prefill and one decode step against JAX's."""
    common.check_prefill("minitron-4b", "reference", kv_repeat=2)
    common.check_teacher_forced_decode("minitron-4b", n_decode=1,
                                       kv_repeat=2)


def test_run_managed_on_cpu_serves_every_batch():
    arch = "minitron-4b"
    amgr = serve.run_managed(arch, n_batches=2, batch_size=2, prompt_len=16,
                             max_new_tokens=4, smoke=True, device="cpu",
                             timeout=120)
    assert amgr.all_done
    vocab = tconfig(arch, smoke=True).vocab_size
    tasks = [t for p in amgr.workflow for s in p.stages for t in s.tasks]
    assert len(tasks) == 2 and all(t.retries == 0 for t in tasks)
    for t in tasks:
        tokens = np.asarray(t.result)
        assert tokens.shape == (2, 4)
        assert ((tokens >= 0) & (tokens < vocab)).all()
    for rec in serve.get_session(arch, True, "cpu").stats[-2:]:
        assert rec["prefill_logits_finite"] and rec["decode_logits_finite"]
        # CPU tensors take the plain versions: no kernel launches
        assert rec["flash_attention_launches"] == 0
        assert rec["mamba2_ssd_launches"] == rec["rwkv6_wkv_launches"] == 0


def test_command_line_serves_stablelm_for_an_embedding_arch(monkeypatch,
                                                            capsys):
    """As the JAX driver does, the command line swaps a configuration that
    takes embeddings for stablelm-12b."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "musicgen-medium", "--device", "cpu",
        "--batches", "1", "--new-tokens", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert ("musicgen-medium takes embedding inputs; using token-input arch "
            "stablelm-12b for the CLI demo") in out
    assert "all DONE: True" in out
