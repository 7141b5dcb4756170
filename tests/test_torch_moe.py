"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU, on the cases of
``tests/test_moe.py`` and a few more.

JAX draws each case's f32 parameters; ``params_from_numpy`` carries them
into the port bit for bit, and both take the same seeded (B, S, D) input.
The chosen experts are compared exactly, and only on inputs whose
smallest top-k margin (the gap between neighbouring probabilities among
each token's K + 1 largest) is larger than the two packages' routing
probabilities differ by (ten times over): a choice that close could flip
on a rounding, and would move a token's output by a whole expert. On these
inputs the margin is at least 5.7e-6 (E = 6, K = 3, T = 31) and the
probabilities differ by at most 2.1e-7, f32 rounding of the router product
and softmax. Then gates, aux loss and outputs at 1e-5 (atol = rtol), f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro.models.config import get_config as jconfig
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.config import get_config as tconfig
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)


def cfgs(E=4, K=2, D=32, F=64, shared=False, cf=1.25):
    kw = dict(name="moe-test", family="moe", n_layers=1, d_model=D,
              n_heads=4, n_kv_heads=2, d_ff=F, vocab_size=64, n_experts=E,
              experts_per_token=K, moe_shared_expert=shared,
              capacity_factor=cf)
    return JConfig(**kw), TConfig(**kw)


def params(jcfg, seed=0):
    """(JAX's f32 MoE parameters, the port's copy)."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, 0, jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def x_in(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def routing_margin(probs: np.ndarray, K: int) -> float:
    """The smallest gap between neighbouring probabilities among each
    token's K + 1 largest (K largest when K = E)."""
    top = -np.sort(-probs, axis=-1)[:, :K + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


def check_route(jcfg, tcfg, jp, tp, jx2d, tx2d):
    """Chosen experts equal, above the stated margin; gates, aux within
    TOL. Returns JAX's experts."""
    jg, je, ja = jmoe._route(jx2d, jp["router"], jcfg)
    tg, te, ta = tmoe._route(tx2d, tp["router"], tcfg)
    jprobs = np.asarray(jax.nn.softmax(jx2d @ jp["router"], axis=-1))
    tprobs = torch.softmax(tx2d @ tp["router"], -1).numpy()
    margin = routing_margin(jprobs, jcfg.experts_per_token)
    err = float(np.max(np.abs(jprobs - tprobs)))
    assert margin > 10 * err, (margin, err)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    return np.asarray(je)


def check_apply(jcfg, tcfg, shape, seed=0, pseed=0):
    """moe_apply on both sides after the routing check: (port's output,
    JAX's) as numpy."""
    jp, tp = params(jcfg, pseed)
    jx, tx = x_in(shape, seed)
    check_route(jcfg, tcfg, jp, tp, jx.reshape(-1, shape[-1]),
                tx.reshape(-1, shape[-1]))
    with jax.default_matmul_precision("highest"):
        jo, ja = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(jp, jx)
    to, ta = tmoe.moe_apply(tp, tx, tcfg)
    assert to.shape == tx.shape and to.dtype == torch.float32
    assert np.isfinite(to.numpy()).all()
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    return to.numpy(), np.asarray(jo)


def test_output_shape_and_finite():
    jcfg, tcfg = cfgs()
    _, _ = check_apply(jcfg, tcfg, (2, 8, jcfg.d_model))


def test_gates_normalized():
    jcfg, tcfg = cfgs(E=8, K=3)
    jp, tp = params(jcfg)
    jx, tx = x_in((16, jcfg.d_model))
    experts = check_route(jcfg, tcfg, jp, tp, jx, tx)
    gates, _, aux = tmoe._route(tx, tp["router"], tcfg)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-6)
    assert experts.min() >= 0 and experts.max() < 8
    assert float(aux) > 0


def test_no_drop_at_high_capacity_equals_dense_mixture():
    """With capacity ≫ tokens the output is each token's explicit mixture
    of its experts, in the port as in JAX."""
    jcfg, tcfg = cfgs(E=4, K=2, cf=32.0)
    out, _ = check_apply(jcfg, tcfg, (1, 6, jcfg.d_model))
    jp, tp = params(jcfg)
    _, tx = x_in((1, 6, jcfg.d_model))
    x2d = tx.reshape(-1, jcfg.d_model).double()
    gates, experts, _ = tmoe._route(x2d.float(), tp["router"], tcfg)
    w = {k: v.double() for k, v in tp.items()}
    expect = torch.zeros_like(x2d)
    for t in range(x2d.shape[0]):
        for j in range(tcfg.experts_per_token):
            e = int(experts[t, j])
            h = torch.nn.functional.silu(x2d[t] @ w["wg"][e]) * (
                x2d[t] @ w["wu"][e])
            expect[t] += float(gates[t, j]) * (h @ w["wd"][e])
    np.testing.assert_allclose(out.reshape(-1, jcfg.d_model),
                               expect.numpy(), atol=2e-5, rtol=2e-5)


def test_capacity_drops_bounded():
    """Capacity 8 against 32 tokens on 2 experts: the layer runs, the
    dropped tokens get zeros, as in JAX."""
    jcfg, tcfg = cfgs(E=2, K=1, cf=0.01)
    out, _ = check_apply(jcfg, tcfg, (2, 16, jcfg.d_model))
    assert tmoe.capacity(32, tcfg) == 8
    dropped = np.all(out.reshape(-1, jcfg.d_model) == 0, axis=-1)
    assert dropped.sum() == 32 - 2 * 8


def test_drops_inside_an_expert_segment_keep_the_earliest_tokens():
    """C = 8 slots an expert against a mean of 16 pairs: within each
    expert's segment the first 8 (token, choice) pairs in token order keep
    their slots and the rest are dropped, as JAX's stable argsort gives.
    An unstable sort keeps other tokens and fails here."""
    jcfg, tcfg = cfgs(E=4, K=2, cf=0.5)
    T = 32
    out, _ = check_apply(jcfg, tcfg, (2, 16, jcfg.d_model), seed=5)
    jp, tp = params(jcfg)
    _, tx = x_in((2, 16, jcfg.d_model), seed=5)
    x2d = tx.reshape(T, -1)
    gates, experts, _ = tmoe._route(x2d, tp["router"], tcfg)
    C = tmoe.capacity(T, tcfg)
    assert C == 8
    seen = {}
    keep = np.zeros((T, 2), bool)
    for t in range(T):
        for k in range(2):
            e = int(experts[t, k])
            keep[t, k] = seen.get(e, 0) < C
            seen[e] = seen.get(e, 0) + 1
    assert any(n > C for n in seen.values()) and not keep.all()
    expect = torch.zeros_like(x2d)
    for t in range(T):
        for k in range(2):
            if keep[t, k]:
                e = int(experts[t, k])
                h = torch.nn.functional.silu(x2d[t] @ tp["wg"][e]) * (
                    x2d[t] @ tp["wu"][e])
                expect[t] += gates[t, k] * (h @ tp["wd"][e])
    np.testing.assert_allclose(out.reshape(T, -1), expect.numpy(),
                               atol=2e-5, rtol=2e-5)


def test_shared_expert_added():
    jcfg_s, tcfg_s = cfgs(shared=True, cf=32.0)
    _, tcfg_n = cfgs(shared=False, cf=32.0)
    out_s, _ = check_apply(jcfg_s, tcfg_s, (1, 4, jcfg_s.d_model))
    _, tp = params(jcfg_s)
    _, tx = x_in((1, 4, jcfg_s.d_model))
    out_n, _ = tmoe.moe_apply({k: v for k, v in tp.items() if k != "shared"},
                              tx, tcfg_n)
    assert float(np.abs(out_s - out_n.numpy()).max()) > 1e-4


@pytest.mark.parametrize("E,K,T", [(2, 1, 4), (3, 2, 17), (8, 3, 32),
                                   (5, 1, 9), (8, 2, 24), (6, 3, 31)])
def test_moe_matches_jax_over_shapes(E, K, T):
    jcfg, tcfg = cfgs(E=E, K=K)
    check_apply(jcfg, tcfg, (1, T, jcfg.d_model), seed=T, pseed=E * 100 + K)


def test_bf16_inputs_match_jax():
    """bf16 input and expert weights (the compute dtype): the gates and
    every product round to bf16 where JAX's do, the sum over K in f32."""
    jcfg, tcfg = cfgs(E=4, K=2, shared=True)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, 0, jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jx, _ = x_in((2, 8, jcfg.d_model), seed=3)
    jx = jx.astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    jo, ja = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(jp, jx)
    to, ta = tmoe.moe_apply(tp, tx, tcfg)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               atol=0.08, rtol=0.05)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)


@pytest.mark.parametrize("T", [1, 7, 64, 100, 2048])
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_capacity_matches_jax(arch, T):
    assert tmoe.capacity(T, tconfig(arch)) == jmoe.capacity(T, jconfig(arch))


# the JAX package's count_params at the published widths: total, active
FULL_PARAMS = {"dbrx-132b": (131_596_523_520, 36_469_708_800),
               "llama4-maverick-400b-a17b": (397_691_950_080,
                                             11_168_486_400)}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_count_params_matches_jax(arch, smoke):
    """Total and active counts equal JAX's, from the meta device. Active
    counts the shared expert at top-k / E too, as JAX does (C10)."""
    tcfg, jcfg = tconfig(arch, smoke=smoke), jconfig(arch, smoke=smoke)
    total, active = tcfg.n_params(), tcfg.n_active_params()
    assert (total, active) == (jcfg.n_params(), jcfg.n_active_params())
    assert ttf.count_params(tcfg, active_only=True) == active
    if not smoke:
        assert (total, active) == FULL_PARAMS[arch]
