"""The port's zamba2 serving path against the JAX package at smoke size.

JAX draws the smoke configuration's bf16 parameters (the serving layout);
``params_from_numpy`` carries them into the port bit for bit. Prompts come
from numpy with a fixed seed. Both sides compute in bf16 and round in a
different order, so logits and cache leaves are held at atol 0.08 /
rtol 0.05, the JAX package's own kernel-vs-reference model tolerance
(``tests/test_kernels.py``). The port calls its kernel wrappers, which
take their plain versions on the CPU; JAX runs both of its routes.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import _merge_cache as jax_merge_cache
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro.models.config import get_config as jconfig
from repro_torch.launch import serve
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.models.config import get_config as tconfig
from repro_torch.models.convert import params_from_numpy

ARCH = "zamba2-7b"
TOL = dict(atol=0.08, rtol=0.05)
B, S, N_DECODE = 2, 32, 4


def _jax_params(seed, dtype):
    cfg = jconfig(ARCH, smoke=True)
    jp = jax.jit(lambda key: jtf.init_params(cfg, key, dtype))(
        jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def weights():
    return _jax_params(0, jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _jax_step(kind, impl="reference"):
    """JAX's jitted bf16 prefill or decode step, compiled once per file."""
    cfg = jconfig(ARCH, smoke=True, attn_impl=impl, scan_impl=impl)
    make = (jsteps.make_prefill_step if kind == "prefill"
            else jsteps.make_decode_step)
    return jax.jit(make(cfg))


def _prompts(seed=0, n=S):
    return np.random.default_rng(seed).integers(
        0, jconfig(ARCH, smoke=True).vocab_size, (B, n)).astype(np.int32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_cache_close(tc, jc):
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]), **TOL)
    for key in ("conv", "ssm"):
        assert tc["mamba"][key].shape == jc["mamba"][key].shape
        np.testing.assert_allclose(_f32(tc["mamba"][key]),
                                   _f32(jc["mamba"][key]), **TOL)


@pytest.mark.parametrize("jax_impl", ["reference", "pallas_interpret"])
def test_prefill_logits_and_cache_match_jax(weights, jax_impl):
    jp, tp = weights
    toks = _prompts()
    jl, jc = _jax_step("prefill", jax_impl)(jp, {"inputs": jnp.asarray(toks)})
    tcfg = tconfig(ARCH, smoke=True)
    tl, tc = tsteps.make_prefill_step(tcfg)(
        tp, {"inputs": torch.from_numpy(toks)})
    assert tl.shape == (B, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), _f32(jl), **TOL)
    _assert_cache_close(tc, jc)
    assert tc["length"] == int(jc["length"]) == S


def _jax_cache_in_port(jc):
    out = params_from_numpy(jax.tree.map(
        np.asarray, {k: v for k, v in jc.items() if k != "length"}), "cpu")
    out["length"] = int(jc["length"])
    return out


def test_teacher_forced_decode_matches_jax(weights):
    """Prefill, then 4 decode steps. Each step both packages get JAX's
    greedy token and JAX's cache, so the step is compared on its own: its
    logits and every updated cache leaf. (Chained over several steps the
    bf16 rounding differences compound: XLA keeps excess f32 precision
    inside fused elementwise chains, PyTorch rounds after every op. The
    chained run is held in f32 below.)"""
    jp, tp = weights
    toks = _prompts(seed=1)
    jcfg = jconfig(ARCH, smoke=True)
    tcfg = tconfig(ARCH, smoke=True)
    jl, jc = _jax_step("prefill")(jp, {"inputs": jnp.asarray(toks)})
    jfull = jax_merge_cache(jtf.init_cache(jcfg, B, S + N_DECODE), jc)
    tdec = tsteps.make_decode_step(tcfg)
    for _ in range(N_DECODE):
        tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        # JAX's decode hands back its conv ring in bf16; back in the f32
        # of init_cache (exact) so that one compiled step serves every step
        jfull["mamba"]["conv"] = jfull["mamba"]["conv"].astype(jnp.float32)
        tfull = _jax_cache_in_port(jfull)
        jl, jfull = _jax_step("decode")(jp, jnp.asarray(tok), jfull)
        tl, tfull = tdec(tp, torch.from_numpy(tok), tfull)
        np.testing.assert_allclose(tl.numpy(), _f32(jl), **TOL)
        _assert_cache_close(tfull, jfull)
        assert tfull["length"] == int(jfull["length"])
    assert tfull["length"] == S + N_DECODE


def test_f32_prefill_and_chained_decode_match_jax(monkeypatch):
    """The algorithm itself, without bf16 rounding: both packages compute
    in f32 (their ``COMPUTE_DTYPE`` set to f32, f32 weights), prefill and
    then decode 4 steps each on its own cache, greedy on its own logits.
    Logits and final caches agree within 1e-4; JAX runs its Pallas
    kernels (interpret mode)."""
    monkeypatch.setattr(jtf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(ttf, "COMPUTE_DTYPE", torch.float32)
    jcfg = jconfig(ARCH, smoke=True, attn_impl="pallas_interpret",
                   scan_impl="pallas_interpret")
    tcfg = tconfig(ARCH, smoke=True)
    jp, tp = _jax_params(1, jnp.float32)
    toks = _prompts(seed=3)
    tol = dict(atol=1e-4, rtol=1e-4)
    with jax.default_matmul_precision("highest"):
        jl, jc = jax.jit(jsteps.make_prefill_step(jcfg))(
            jp, {"inputs": jnp.asarray(toks)})
        jdec = jax.jit(jsteps.make_decode_step(jcfg))
        jfull = jax_merge_cache(jtf.init_cache(jcfg, B, S + N_DECODE), jc)
        tl, tc = tsteps.make_prefill_step(tcfg)(
            tp, {"inputs": torch.from_numpy(toks)})
        np.testing.assert_allclose(tl.numpy(), _f32(jl), **tol)
        tfull = serve._merge_cache(
            ttf.init_cache(tcfg, B, S + N_DECODE, "cpu"), tc)
        tdec = tsteps.make_decode_step(tcfg)
        for _ in range(N_DECODE):
            jtok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
            ttok = torch.argmax(tl, dim=-1)[:, None].to(torch.int32)
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
            jl, jfull = jdec(jp, jtok, jfull)
            tl, tfull = tdec(tp, ttok, tfull)
            np.testing.assert_allclose(tl.numpy(), _f32(jl), **tol)
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(tfull[key]), _f32(jfull[key]), **tol)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(_f32(tfull["mamba"][key]),
                                   _f32(jfull["mamba"][key]), **tol)


def test_decode_consistent_with_prefill(weights):
    """prefill(x[:S]) then decode(x[S]) ≈ prefill(x[:S+1]), as the JAX
    package checks its own model (``tests/test_models.py``)."""
    _, tp = weights
    cfg = tconfig(ARCH, smoke=True)
    tokens = torch.from_numpy(_prompts(seed=2, n=13)[:1])
    pf, dec = tsteps.make_prefill_step(cfg), tsteps.make_decode_step(cfg)
    logits_a, _ = pf(tp, {"inputs": tokens})
    _, cache = pf(tp, {"inputs": tokens[:, :12]})
    big = serve._merge_cache(ttf.init_cache(cfg, 1, 14, "cpu"), cache)
    logits_b, big = dec(tp, tokens[:, 12:13], big)
    a, b = logits_a.numpy(), logits_b.numpy()
    assert np.argmax(a) == np.argmax(b)
    assert float(np.max(np.abs(a - b))) < 0.15
    assert big["length"] == 13


def test_run_managed_on_cpu_serves_every_batch():
    amgr = serve.run_managed(ARCH, n_batches=2, batch_size=2, prompt_len=16,
                             max_new_tokens=4, smoke=True, device="cpu",
                             timeout=120)
    assert amgr.all_done
    vocab = tconfig(ARCH, smoke=True).vocab_size
    tasks = [t for p in amgr.workflow for s in p.stages for t in s.tasks]
    assert len(tasks) == 2 and all(t.retries == 0 for t in tasks)
    for t in tasks:
        tokens = np.asarray(t.result)
        assert tokens.shape == (2, 4)
        assert ((tokens >= 0) & (tokens < vocab)).all()
    for rec in serve.get_session(ARCH, True, "cpu").stats[-2:]:
        assert rec["prefill_logits_finite"] and rec["decode_logits_finite"]
        # CPU tensors take the plain versions: no kernel launches
        assert rec["flash_attention_launches"] == 0
        assert rec["mamba2_ssd_launches"] == 0


def test_get_session_builds_one_session_under_concurrency(monkeypatch):
    built = []
    real = ttf.init_params

    def slow_init(*args, **kwargs):
        built.append(1)
        threading.Event().wait(0.2)
        return real(*args, **kwargs)

    monkeypatch.setattr(ttf, "init_params", slow_init)
    monkeypatch.setattr(serve, "_SESSIONS", {})
    barrier = threading.Barrier(2)
    got = []

    def call():
        barrier.wait()
        got.append(serve.get_session(ARCH, True, "cpu"))

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(built) == 1 and len(got) == 2 and got[0] is got[1]


def test_count_params_at_full_width_allocates_nothing():
    cfg = tconfig(ARCH)
    assert ttf.count_params(cfg) == cfg.n_params() == 6_751_130_832
    assert ttf.count_params(cfg) == jconfig(ARCH).n_params()
    meta = ttf.init_params(cfg, device="meta")
    leaves = list(ttf._leaves(meta))
    assert leaves and all(leaf.is_meta for leaf in leaves)


def test_bf16_round_trip_is_bit_exact():
    x = jax.random.normal(jax.random.PRNGKey(3), (7, 33), jnp.bfloat16)
    tree = {"a": np.asarray(x), "b": {"c": np.arange(5, dtype=np.int32)}}
    out = params_from_numpy(tree, "cpu")
    assert out["a"].dtype == torch.bfloat16 and out["b"]["c"].dtype == \
        torch.int32
    np.testing.assert_array_equal(out["a"].view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
    back = out["a"].view(torch.int16).numpy().view(np.asarray(x).dtype)
    np.testing.assert_array_equal(back, np.asarray(x))


def _shapes(tree):
    """{path: (shape, dtype name)} of a nested dict of arrays or
    tensors."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update({f"{key}/{k}": v for k, v in _shapes(leaf).items()})
        elif key != "length":
            out[key] = (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_moe_families_init_like_jax(arch, smoke):
    """The configurations with experts (the ``moe`` family) are ported:
    ``init_params`` (on the meta device at full width) and ``init_cache``
    give the JAX package's keys, shapes and dtypes, so ``params_from_numpy``
    carries JAX's parameters over unchanged."""
    jcfg, tcfg = jconfig(arch, smoke=smoke), tconfig(arch, smoke=smoke)
    jp = jax.eval_shape(lambda k: jtf.init_params(jcfg, k, jnp.float32),
                        jax.random.PRNGKey(0))
    tp = ttf.init_params(tcfg, device="meta" if not smoke else "cpu")
    assert _shapes(tp) == _shapes(jp)
    assert "moe" in tp["blocks"] and tp["blocks"]["moe"]["router"].dtype \
        == torch.float32
    jc = jax.eval_shape(lambda: jtf.init_cache(jcfg, 2, 8))
    tc = ttf.init_cache(tcfg, 2, 8, "cpu")
    assert _shapes(tc) == _shapes(jc) and tc["length"] == 0
