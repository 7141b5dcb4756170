"""The port's train step against the JAX package's for the ssm family (rwkv6-3b) at smoke size on the CPU.

On the CPU the scan's ``autograd.Function`` takes its plain forward and
plain backward (the gradient JAX takes of its differentiable reference
scans); on the card, its forward and backward CUDA kernels
(``tests/test_torch_gpu.py`` holds a smoke train step on the card to the
same step on the CPU). Per configuration: ``loss_fn`` and every gradient
leaf in f32 within 1e-4 of JAX's; ``adamw_update`` fed
JAX's gradients within 1e-6 of JAX's update; one ``make_train_step``
step; remat on against off. Shared cases and tolerances:
``tests/_torch_train.py``.
"""

import pytest

from _torch_train import (check_adamw_on_the_same_grads,
                          check_loss_and_grads, check_remat_on_and_off,
                          check_train_step)

ARCHS = ["rwkv6-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, monkeypatch):
    check_loss_and_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_on_the_same_grads_matches_jax(arch, monkeypatch):
    check_adamw_on_the_same_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, monkeypatch):
    check_train_step(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_agree(arch, monkeypatch):
    check_remat_on_and_off(arch, monkeypatch)
