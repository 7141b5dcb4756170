"""Shared by the attention-stack serve tests
(``test_torch_{dense,dense_variants,embed}_serve.py``): the port's dense,
vlm and audio families against the JAX package at smoke size.

JAX draws each smoke configuration's parameters; ``params_from_numpy``
carries them into the port bit for bit. Inputs come from numpy with a
fixed seed: token ids, or bf16 embeddings (B, S, d_model) for the
configurations that take embeddings, and for M-RoPE (qwen2-vl) distinct
random position streams (B, 3, S). bf16 prefill logits and caches and
single teacher-forced decode steps are held at atol 0.08 / rtol 0.05, the
JAX package's kernel-vs-reference model tolerance; f32 prefill and chained
decode at 1e-4 (chained bf16 decode drifts further: ROADMAP C3). The
port's wrappers take their plain versions on the CPU; JAX runs both of its
attention routes (the Pallas kernel in interpret mode, S one block).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.serve import _merge_cache as jax_merge_cache
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro.models.config import get_config as jconfig
from repro_torch.launch import serve
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.models.config import get_config as tconfig
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

TOL = dict(atol=0.08, rtol=0.05)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, N_DECODE = 2, 32, 4


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@functools.lru_cache(maxsize=None)
def jax_params(arch, seed=0, dtype=jnp.bfloat16, **overrides):
    """(JAX's parameters, the port's copy of them)."""
    cfg = jconfig(arch, smoke=True, **overrides)
    jp = jax.jit(lambda key: jtf.init_params(cfg, key, dtype))(
        jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def jax_step(arch, kind, impl="reference", **overrides):
    """JAX's jitted prefill or decode step, compiled once per process."""
    cfg = jconfig(arch, smoke=True, attn_impl=impl, scan_impl=impl,
                  **overrides)
    make = (jsteps.make_prefill_step if kind == "prefill"
            else jsteps.make_decode_step)
    return jax.jit(make(cfg))


def inputs(arch, seed, n=S, batch=B):
    """(JAX's inputs, the port's): token ids, or bf16 embeddings with the
    same bits on both sides."""
    cfg = jconfig(arch, smoke=True)
    rng = np.random.default_rng(seed)
    if not cfg.embedding_inputs:
        toks = rng.integers(0, cfg.vocab_size, (batch, n)).astype(np.int32)
        return jnp.asarray(toks), torch.from_numpy(toks)
    x = jnp.asarray(rng.standard_normal((batch, n, cfg.d_model)),
                    jnp.bfloat16)
    return x, tensor_from_numpy(np.asarray(x), "cpu")


def batches(arch, seed, n=S):
    """(JAX's prefill batch, the port's), with random (B, 3, n) position
    streams for M-RoPE."""
    jx, tx = inputs(arch, seed, n)
    jb, tb = {"inputs": jx}, {"inputs": tx}
    if jconfig(arch, smoke=True).rope_variant == "mrope":
        pos = np.random.default_rng(seed + 100).integers(
            0, 4 * n, (B, 3, n)).astype(np.int32)
        jb["positions"], tb["positions"] = (jnp.asarray(pos),
                                            torch.from_numpy(pos))
    return jb, tb


def next_tokens(arch, jl, step):
    """The next decode input of both packages: JAX's greedy token, or a
    seeded (B, 1, d_model) bf16 embedding."""
    if jconfig(arch, smoke=True).embedding_inputs:
        return inputs(arch, 1000 + step, n=1)
    tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
    return jnp.asarray(tok), torch.from_numpy(tok)


def assert_cache_close(tc, jc, tol=TOL):
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape
        np.testing.assert_allclose(f32(tc[key]), f32(jc[key]), **tol)


def jax_cache_in_port(jc):
    out = params_from_numpy(jax.tree.map(
        np.asarray, {k: v for k, v in jc.items() if k != "length"}), "cpu")
    out["length"] = int(jc["length"])
    return out


def check_prefill(arch, jax_impl, seed=0, **overrides):
    """bf16 prefill logits and cache against JAX's ``jax_impl`` route."""
    jp, tp = jax_params(arch, **overrides)
    jb, tb = batches(arch, seed)
    jl, jc = jax_step(arch, "prefill", jax_impl, **overrides)(jp, jb)
    tcfg = tconfig(arch, smoke=True, **overrides)
    tl, tc = tsteps.make_prefill_step(tcfg)(tp, tb)
    assert tl.shape == (B, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), f32(jl), **TOL)
    Hkv = tcfg.n_kv_heads * tcfg.kv_repeat
    assert tc["k"].shape == (tcfg.n_layers, B, S, Hkv,
                             tcfg.resolved_head_dim)
    assert tc["k"].dtype == torch.bfloat16
    assert_cache_close(tc, jc)
    assert tc["length"] == int(jc["length"]) == S


def check_teacher_forced_decode(arch, seed=1, n_decode=N_DECODE,
                                **overrides):
    """Prefill, then decode steps, each fed JAX's input and JAX's cache so
    that every step is compared on its own: its logits and its cache."""
    jp, tp = jax_params(arch, **overrides)
    jcfg = jconfig(arch, smoke=True, **overrides)
    tcfg = tconfig(arch, smoke=True, **overrides)
    jb, _ = batches(arch, seed)
    jl, jc = jax_step(arch, "prefill", **overrides)(jp, jb)
    jfull = jax_merge_cache(jtf.init_cache(jcfg, B, S + n_decode), jc)
    tdec = tsteps.make_decode_step(tcfg)
    jdec = jax_step(arch, "decode", **overrides)
    for step in range(n_decode):
        jtok, ttok = next_tokens(arch, jl, step)
        tfull = jax_cache_in_port(jfull)
        jl, jfull = jdec(jp, jtok, jfull)
        tl, tfull = tdec(tp, ttok, tfull)
        np.testing.assert_allclose(tl.numpy(), f32(jl), **TOL)
        assert_cache_close(tfull, jfull)
        assert tfull["length"] == int(jfull["length"])
    assert tfull["length"] == S + n_decode


def check_f32_prefill_and_chained_decode(arch, monkeypatch, seed=3):
    """Both packages in f32 (``COMPUTE_DTYPE`` f32, f32 weights): prefill,
    then decode on each one's own cache, greedy on each one's own logits
    (or the same seeded embeddings). JAX runs its Pallas kernel in
    interpret mode."""
    monkeypatch.setattr(jtf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(ttf, "COMPUTE_DTYPE", torch.float32)
    jcfg = jconfig(arch, smoke=True, attn_impl="pallas_interpret",
                   scan_impl="pallas_interpret")
    tcfg = tconfig(arch, smoke=True)
    jp = jax.jit(lambda key: jtf.init_params(jcfg, key, jnp.float32))(
        jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jb, tb = batches(arch, seed)
    embeds = jcfg.embedding_inputs
    with jax.default_matmul_precision("highest"):
        jl, jc = jax.jit(jsteps.make_prefill_step(jcfg))(jp, jb)
        jdec = jax.jit(jsteps.make_decode_step(jcfg))
        jfull = jax_merge_cache(jtf.init_cache(jcfg, B, S + N_DECODE), jc)
        tl, tc = tsteps.make_prefill_step(tcfg)(tp, tb)
        np.testing.assert_allclose(tl.numpy(), f32(jl), **F32_TOL)
        tfull = serve._merge_cache(
            ttf.init_cache(tcfg, B, S + N_DECODE, "cpu"), tc)
        tdec = tsteps.make_decode_step(tcfg)
        for step in range(N_DECODE):
            if embeds:
                jtok, ttok = inputs(arch, 1000 + step, n=1)
            else:
                jtok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
                ttok = torch.argmax(tl, dim=-1)[:, None].to(torch.int32)
                np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
            jl, jfull = jdec(jp, jtok, jfull)
            tl, tfull = tdec(tp, ttok, tfull)
            np.testing.assert_allclose(tl.numpy(), f32(jl), **F32_TOL)
    assert_cache_close(tfull, jfull, F32_TOL)


def check_decode_consistent_with_prefill(arch):
    """prefill(x[:13]) ≈ prefill(x[:12]) then decode(x[12]), as the JAX
    package checks its own model (``tests/test_models.py``)."""
    _, tp = jax_params(arch)
    cfg = tconfig(arch, smoke=True)
    _, x = inputs(arch, 2, n=13, batch=1)
    pf, dec = tsteps.make_prefill_step(cfg), tsteps.make_decode_step(cfg)
    logits_a, _ = pf(tp, {"inputs": x})
    _, cache = pf(tp, {"inputs": x[:, :12]})
    big = serve._merge_cache(ttf.init_cache(cfg, 1, 14, "cpu"), cache)
    logits_b, big = dec(tp, x[:, 12:13], big)
    a, b = logits_a.numpy(), logits_b.numpy()
    assert np.argmax(a) == np.argmax(b)
    assert float(np.max(np.abs(a - b))) < 0.15
    assert big["length"] == 13


def check_count_params(arch, expected):
    """Full-width parameter count from the meta device (nothing
    allocated), equal to the JAX package's."""
    cfg = tconfig(arch)
    assert ttf.count_params(cfg) == cfg.n_params() == expected
    assert expected == jconfig(arch).n_params()
    meta = ttf.init_params(cfg, device="meta")
    leaves = list(ttf._leaves(meta))
    assert leaves and all(leaf.is_meta for leaf in leaves)
    assert ("embed" in meta) == (not cfg.embedding_inputs)
    assert set(meta["blocks"]) == {"norms", "attn", "mlp"}
    assert ("wg" in meta["blocks"]["mlp"]) == cfg.mlp_gated
    assert meta["blocks"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
