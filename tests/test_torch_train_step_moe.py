"""The port's train step against the JAX package's for the MoE family
(dbrx-132b, llama4-maverick-400b-a17b) at smoke size on the CPU.

Per configuration, in f32: the loss (cross-entropy plus ``AUX_COEF`` times
the MoE layers' summed load-balance loss), its two terms and every
gradient leaf within 1e-4 of JAX's, the router's and the experts'
included; remat on against off (one checkpoint a layer, the MoE layers'
recomputation equal to their first pass); and one ``make_train_step``
step (AdamW itself is held to JAX's in ``test_torch_train_step.py``).
The bf16 step and the launcher are in ``test_torch_train_moe.py``;
shared cases and tolerances are in ``tests/_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (F32_TOL, batch_np, check_loss_and_grads,
                          check_remat_on_and_off, check_train_step,
                          jax_loss_and_grads, jax_params, port_state,
                          set_f32, to_jax, to_torch)
from repro.models import steps as jsteps
from repro.models.config import get_config as jconfig
from repro_torch.models import steps as tsteps
from repro_torch.models.config import get_config as tconfig

ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, monkeypatch):
    check_loss_and_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_reaches_the_loss_and_the_router(arch, monkeypatch):
    """``loss_fn``'s terms in f32 against JAX's: the aux loss is positive,
    the loss is ce + AUX_COEF * aux on both sides, and the router of every
    MoE layer has a nonzero gradient equal to JAX's (above)."""
    set_f32(monkeypatch)
    jcfg, tcfg = jconfig(arch, smoke=True), tconfig(arch, smoke=True)
    jl, jm = jax.jit(lambda p, b: jsteps.loss_fn(p, jcfg, b))(
        jax.tree.map(jnp.asarray, jax_params(arch)), to_jax(batch_np(arch)))
    with torch.no_grad():
        tl, tm = tsteps.loss_fn(port_state(arch)["params"], tcfg,
                                to_torch(batch_np(arch)))
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   **F32_TOL)
    assert float(tm["aux"]) > 0
    assert float(tl) == pytest.approx(
        float(tm["ce"]) + tsteps.AUX_COEF * float(tm["aux"]), rel=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), **F32_TOL)
    router = jax_loss_and_grads(arch, "f32")[1]["blocks"]["moe"]["router"]
    assert router.shape[0] == tcfg.n_layers // tcfg.moe_layer_period
    assert all(np.abs(g).max() > 0 for g in router)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, monkeypatch):
    check_train_step(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_agree(arch, monkeypatch):
    check_remat_on_and_off(arch, monkeypatch)
