"""Shared by the train-step tests (``test_torch_train_step*.py``): the
port's ``loss_fn``, ``make_train_step`` and ``adamw_update`` against the
JAX package's at smoke size.

JAX draws each smoke configuration's f32 parameters;
``train_state_from_numpy`` carries them (and a fresh AdamW state) into the
port bit for bit. Batches come from numpy with a fixed seed: token ids or
f32 embeddings (the data stream's scale, 0.02), labels, and for M-RoPE
distinct random (B, 3, S) position streams. JAX's loss and gradients are
computed once per configuration and compute dtype (``jax.jit`` of
``value_and_grad``, the reference attention and scan routes, which are
what the JAX package trains through) and cached: each test file is one
process under xdist's ``loadfile``.

f32 runs set ``COMPUTE_DTYPE`` to f32 in both packages (the callers'
``monkeypatch``, as ``tests/_torch_attn_stack.py`` does) and JAX's matmul
precision to "highest": the loss and every gradient leaf are held at 1e-4
(atol = rtol). bf16 runs are held at the JAX package's kernel-vs-reference
model tolerance, atol 0.08 / rtol 0.05.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro.models.config import get_config as jconfig
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import rwkv6_wkv as twkv
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.models.config import get_config as tconfig
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.optim.adamw import AdamWConfig as TAdamW
from repro_torch.optim.adamw import adamw_update as tadamw_update

from _torch_update import (assert_moments_close, assert_update_written,
                           clone_tree)

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.08, rtol=0.05)
B, S = 2, 32


def set_f32(monkeypatch) -> None:
    monkeypatch.setattr(jtf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(ttf, "COMPUTE_DTYPE", torch.float32)


def dtype_key() -> str:
    """The compute dtype both packages run at now (a cache key)."""
    assert (jtf.COMPUTE_DTYPE == jnp.float32) == (
        ttf.COMPUTE_DTYPE == torch.float32)
    return "f32" if ttf.COMPUTE_DTYPE == torch.float32 else "bf16"


@functools.lru_cache(maxsize=None)
def jax_params(arch, seed=0):
    cfg = jconfig(arch, smoke=True)
    jp = jax.jit(lambda key: jtf.init_params(cfg, key, jnp.float32))(
        jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, jp)


@functools.lru_cache(maxsize=None)
def batch_np(arch, seed=0, batch=B, seq=S):
    cfg = jconfig(arch, smoke=True)
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        x = (rng.standard_normal((batch, seq, cfg.d_model)) * 0.02
             ).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"inputs": x, "labels": rng.integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.rope_variant == "mrope":
        out["positions"] = rng.integers(0, 4 * seq, (batch, 3, seq)
                                        ).astype(np.int32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch, dtype, seed=0, batch=B, seq=S):
    """(loss, grads as numpy) of JAX's ``loss_fn`` at ``dtype`` (the
    caller has set it: the key keeps f32 and bf16 results apart)."""
    assert dtype == dtype_key()
    cfg = jconfig(arch, smoke=True)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, cfg, b), has_aux=True))
    with jax.default_matmul_precision(
            "highest" if dtype == "f32" else "default"):
        (loss, _), grads = fn(jax.tree.map(jnp.asarray, jax_params(arch)),
                              to_jax(batch_np(arch, seed, batch, seq)))
    return float(loss), jax.tree.map(np.asarray, grads)


def port_state(arch, seed=0):
    """The port's train state from JAX's parameters and a fresh AdamW."""
    jp = jax_params(arch, seed)
    opt = jax.tree.map(np.asarray, jadamw_init(jp))
    return train_state_from_numpy({"params": jp, "opt": opt}, "cpu")


def port_loss_and_grads(arch, seed=0, batch=B, seq=S, **overrides):
    cfg = tconfig(arch, smoke=True, **overrides)
    params = port_state(arch)["params"]
    masters = tsteps.leaves(params)
    for p in masters:
        p.requires_grad_(True)
    loss, _ = tsteps.loss_fn(params, cfg, to_torch(batch_np(arch, seed,
                                                            batch, seq)))
    grads = torch.autograd.grad(loss, masters)
    return float(loss.detach()), tsteps.unflatten(
        params, [g.numpy() for g in grads])


def assert_trees_close(got, want, tol, what=""):
    """Every leaf of two nested dicts of arrays, leaf by leaf."""
    assert sorted(got) == sorted(want), what
    for key in got:
        if isinstance(got[key], dict):
            assert_trees_close(got[key], want[key], tol, f"{what}/{key}")
        else:
            a = got[key]
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            np.testing.assert_allclose(
                a.astype(np.float64), np.asarray(want[key], np.float64),
                err_msg=f"{what}/{key}", **tol)


@functools.lru_cache(maxsize=None)
def jax_update(arch):
    """JAX's ``adamw_update`` of JAX's parameters by JAX's f32 gradients:
    (params, opt, metrics) as numpy."""
    jp = jax.tree.map(jnp.asarray, jax_params(arch))
    grads = jax.tree.map(jnp.asarray, jax_loss_and_grads(arch, "f32")[1])
    out = jax.jit(lambda g, p: jadamw_update(g, jadamw_init(p), p,
                                             JAdamW()))(grads, jp)
    return jax.tree.map(np.asarray, out)


def check_loss_and_grads(arch, monkeypatch):
    set_f32(monkeypatch)
    jl, jg = jax_loss_and_grads(arch, "f32")
    tl, tg = port_loss_and_grads(arch)
    np.testing.assert_allclose(tl, jl, **F32_TOL)
    assert_trees_close(tg, jg, F32_TOL, arch)


def check_adamw_on_the_same_grads(arch, monkeypatch):
    """The port's ``adamw_update``, fed JAX's gradients, writes JAX's
    update in place, within 1e-6 (f32 rounding of the same formula)."""
    set_f32(monkeypatch)
    _, jg = jax_loss_and_grads(arch, "f32")
    state = port_state(arch)
    params, opt = state["params"], state["opt"]
    grads = params_from_numpy(jg, "cpu")
    out_p, out_opt, metrics = tadamw_update(grads, opt, params, TAdamW())
    assert out_p is params and out_opt is opt      # in place
    want_p, want_opt, want_m = jax_update(arch)
    tol = dict(atol=1e-6, rtol=1e-6)
    assert_trees_close(params, want_p, tol, "params")
    assert_trees_close({"m": opt["m"], "v": opt["v"]},
                       {"m": want_opt["m"], "v": want_opt["v"]}, tol, "opt")
    assert int(opt["step"]) == int(want_opt["step"]) == 1
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["lr"]), float(want_m["lr"]),
                               rtol=1e-6)


def check_train_step(arch, monkeypatch):
    """One ``make_train_step`` step in f32 against JAX's loss, grad norm,
    lr and ``adamw_update`` of JAX's gradients: the moments leaf by leaf
    (m̂ and √v̂, the clipped gradient and its magnitude at step 1) at the
    gradients' tolerance, and each parameter written from its own
    moments (``tests/_torch_update.py``: a move of ±lr = 3e-6 is below
    any tolerance on the parameters themselves)."""
    set_f32(monkeypatch)
    jl, jg = jax_loss_and_grads(arch, "f32")
    want_p, want_opt, want_m = jax_update(arch)
    state = port_state(arch)
    params = state["params"]
    before = clone_tree(params)
    step = tsteps.make_train_step(tconfig(arch, smoke=True))
    out, metrics = step(state, to_torch(batch_np(arch)))
    assert out is state and out["params"] is params
    assert not any(p.requires_grad for p in tsteps.leaves(params))
    np.testing.assert_allclose(float(metrics["loss"]), jl, **F32_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(want_m["grad_norm"]), **F32_TOL)
    np.testing.assert_allclose(float(metrics["lr"]), float(want_m["lr"]),
                               rtol=1e-6)
    assert int(state["opt"]["step"]) == 1
    assert_moments_close(state["opt"], want_opt, F32_TOL)
    assert_update_written(before, params, state["opt"], float(metrics["lr"]))


def count_calls(monkeypatch, module, name):
    """Wrap ``module.name`` to count its calls; returns the counter."""
    calls = [0]
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)
    return calls


def check_remat_on_and_off(arch, monkeypatch):
    """``remat="full"`` (one checkpoint a layer) and ``"none"`` give the
    same loss and gradients, and JAX's. With remat each layer's kernels
    run twice forward (the pass and its recomputation): flash once an
    attention application, SSD or WKV once a Mamba-2 or RWKV layer;
    without it once. Flash's backward runs once an application either
    way."""
    set_f32(monkeypatch)
    counts = {name: count_calls(monkeypatch, module, name)
              for module, name in ((tfa, "flash_attention_plain"),
                                   (tfa, "flash_attention_bwd_plain"),
                                   (tssd, "mamba2_ssd_plain"),
                                   (twkv, "rwkv6_wkv_plain"))}
    jl, jg = jax_loss_and_grads(arch, "f32")
    cfg = tconfig(arch, smoke=True)
    attn = {"ssm": 0, "hybrid": cfg.n_layers // (cfg.attn_every or 1)
            }.get(cfg.family, cfg.n_layers)
    scans = {"hybrid": ("mamba2_ssd_plain", cfg.n_layers),
             "ssm": ("rwkv6_wkv_plain", cfg.n_layers)}.get(cfg.family)
    results = {}
    for remat, times in (("full", 2), ("none", 1)):
        for c in counts.values():
            c[0] = 0
        results[remat] = port_loss_and_grads(arch, remat=remat)
        want = {"flash_attention_plain": times * attn,
                "flash_attention_bwd_plain": attn,
                "mamba2_ssd_plain": 0, "rwkv6_wkv_plain": 0}
        if scans:
            want[scans[0]] = times * scans[1]
        assert {k: c[0] for k, c in counts.items()} == want, remat
    (l_on, g_on), (l_off, g_off) = results["full"], results["none"]
    assert l_on == l_off
    assert_trees_close(g_on, g_off, dict(atol=1e-6, rtol=1e-6), "remat")
    np.testing.assert_allclose(l_on, jl, **F32_TOL)
    assert_trees_close(g_on, jg, F32_TOL, arch)


def check_bf16_step(arch):
    """One step in the working precision (bf16 compute copies of f32
    masters): the loss and every gradient against JAX's at the model
    tolerance; the step's loss too, and its update is finite."""
    jl, jg = jax_loss_and_grads(arch, "bf16")
    tl, tg = port_loss_and_grads(arch)
    np.testing.assert_allclose(tl, jl, **BF16_TOL)
    assert_trees_close(tg, jg, BF16_TOL, arch)
    state = port_state(arch)
    out, metrics = tsteps.make_train_step(tconfig(arch, smoke=True))(
        state, to_torch(batch_np(arch)))
    np.testing.assert_allclose(float(metrics["loss"]), jl, **BF16_TOL)
    assert all(bool(torch.isfinite(p).all())
               for p in tsteps.leaves(out["params"]))
