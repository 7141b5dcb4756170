"""The port's MoE family (dbrx-132b: every layer MoE, top-4 of 16;
llama4-maverick: dense and MoE layers in turn, top-1 of 128 with a shared
expert) against the JAX package at smoke size: prefill logits and cache
(bf16, both of JAX's attention routes), teacher-forced decode steps (bf16)
and f32 prefill with chained greedy decode, with JAX's parameters carried
over. The cases and their tolerances are in ``_torch_attn_stack.py``: bf16
single steps at the model tolerance, f32 chains at 1e-4 (bf16 chains
drift further, ROADMAP C3). Then serving through ``run_managed``."""

import numpy as np
import pytest

import _torch_attn_stack as common
from repro_torch.launch import serve
from repro_torch.models.config import get_config as tconfig

ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]


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
def test_run_managed_on_cpu_serves_every_batch(arch):
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
        assert rec["flash_attention_launches"] == 0   # CPU: plain versions
