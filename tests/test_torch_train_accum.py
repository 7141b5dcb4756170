"""The port's gradient accumulation and chunked cross-entropy against the
JAX package's, on the CPU at smoke size.

``make_train_step(accum_steps=2)`` of qwen2-vl-2b (its M-RoPE (B, 3, S)
positions split with the batch) against JAX's jitted train step with the
same accumulation, in f32; and ``chunked_ce_loss`` at S = 1200, past one
``CE_CHUNK``, against JAX's and against one unchunked cross-entropy.
Shared helpers and tolerances: ``tests/_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_train import (F32_TOL, batch_np, port_state, set_f32, to_jax,
                          to_torch)
from _torch_update import (assert_moments_close, assert_update_written,
                           clone_tree)
from repro.models import steps as jsteps
from repro.models.config import get_config as jconfig
from repro_torch.models import steps as tsteps
from repro_torch.models.config import get_config as tconfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.mlp import rms_norm


def test_accum_steps_two_matches_jax(monkeypatch):
    """Two microbatches of 2 (M-RoPE positions split with the batch):
    the mean loss, the grad norm and the moments (the accumulated, clipped
    gradient) against JAX's ``make_train_step(accum_steps=2)``, and each
    parameter written from its own moments."""
    set_f32(monkeypatch)
    arch = "qwen2-vl-2b"
    batch = batch_np(arch, seed=1, batch=4)
    jcfg = jconfig(arch, smoke=True)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    with jax.default_matmul_precision("highest"):
        jout, jm = jax.jit(jsteps.make_train_step(jcfg, accum_steps=2))(
            jstate, to_jax(batch))
    state = port_state(arch)
    before = clone_tree(state["params"])
    step = tsteps.make_train_step(tconfig(arch, smoke=True), accum_steps=2)
    out, metrics = step(state, to_torch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               **F32_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), **F32_TOL)
    np.testing.assert_allclose(float(metrics["lr"]), float(jm["lr"]),
                               rtol=1e-6)
    assert_moments_close(out["opt"], jax.tree.map(np.asarray, jout["opt"]),
                         F32_TOL)
    assert_update_written(before, out["params"], out["opt"],
                          float(metrics["lr"]))


def test_chunked_ce_loss_past_one_chunk_matches_jax():
    """S = 1200 > CE_CHUNK: three chunks of 400 (the largest divisor up to
    512). The loss and its gradients (hidden states, head, final norm)
    against JAX's and against one unchunked cross-entropy."""
    arch = "minitron-4b"
    cfg_j, cfg_t = jconfig(arch, smoke=True), tconfig(arch, smoke=True)
    rng = np.random.default_rng(2)
    Bn, Sn, D = 2, 1200, cfg_t.d_model
    hidden = rng.standard_normal((Bn, Sn, D)).astype(np.float32)
    labels = rng.integers(0, cfg_t.vocab_size, (Bn, Sn)).astype(np.int32)
    head = {"final_norm": (1 + 0.1 * rng.standard_normal(D)
                           ).astype(np.float32),
            "lm_head": (rng.standard_normal((D, cfg_t.vocab_size))
                        / np.sqrt(D)).astype(np.float32)}

    @jax.jit
    def jrun(p, h):
        return jax.value_and_grad(
            lambda p, h: jsteps.chunked_ce_loss(p, cfg_j, h,
                                                jnp.asarray(labels)),
            argnums=(0, 1))(p, h)

    with jax.default_matmul_precision("highest"):
        jl, (jgp, jgh) = jrun(jax.tree.map(jnp.asarray, head),
                              jnp.asarray(hidden))
    tp = params_from_numpy(head, "cpu")
    th = torch.from_numpy(hidden).requires_grad_(True)
    for t in tp.values():
        t.requires_grad_(True)
    tl = tsteps.chunked_ce_loss(tp, cfg_t, th, torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, [tp["final_norm"], tp["lm_head"], th])
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32_TOL)
    for got, want in zip(grads, (jgp["final_norm"], jgp["lm_head"], jgh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # one unchunked cross-entropy over the whole (B, S, V)
    logits = (rms_norm(th, tp["final_norm"], cfg_t.norm_eps)
              @ tp["lm_head"]).float()
    whole = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg_t.vocab_size),
        torch.from_numpy(labels).long().reshape(-1))
    np.testing.assert_allclose(float(tl.detach()), float(whole.detach()),
                               rtol=1e-5)
