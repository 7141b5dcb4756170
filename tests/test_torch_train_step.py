"""The port's train step against the JAX package's for the dense family
(stablelm-12b, minitron-4b) at smoke size on the CPU, where flash
attention's forward and backward take their plain versions.

Per configuration: ``loss_fn`` and every gradient leaf in f32 within 1e-4
of JAX's; ``adamw_update`` fed JAX's gradients within 1e-6 of JAX's
update; one ``make_train_step`` step. Then remat on against off and one
bf16 step at the model tolerance (the chunked cross-entropy past one chunk
and gradient accumulation are in ``test_torch_train_accum.py``). The vlm and audio configurations are in
``test_torch_train_step_embed.py``, the hybrid and ssm ones in
``test_torch_train_step_{hybrid,ssm}.py``; shared cases and tolerances in
``tests/_torch_train.py``.
"""

import pytest

from _torch_train import (check_adamw_on_the_same_grads, check_bf16_step,
                          check_loss_and_grads, check_remat_on_and_off,
                          check_train_step)

ARCHS = ["stablelm-12b", "minitron-4b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, monkeypatch):
    check_loss_and_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_on_the_same_grads_matches_jax(arch, monkeypatch):
    check_adamw_on_the_same_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, monkeypatch):
    check_train_step(arch, monkeypatch)


@pytest.mark.parametrize("arch", ["minitron-4b"])
def test_remat_on_and_off_agree(arch, monkeypatch):
    check_remat_on_and_off(arch, monkeypatch)


@pytest.mark.parametrize("arch", ["minitron-4b"])
def test_bf16_train_step_within_model_tolerance(arch):
    check_bf16_step(arch)
