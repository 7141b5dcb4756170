"""The port's seismic app against the JAX package's, on the CPU.

The solver (forward seismograms, misfit, adjoint gradient) from the same
velocity model, and the misfit sweeps through each package's RTS: the
forward→misfit chain alone (chain tier), the chain with its Σ gather and
the single-kernel sweep with its Σ gather (DAG tier). Seismic values are
held to 1e-4 relative: misfits element by element, seismograms and
gradients by their largest error against their largest magnitude (a
field's near-zero entries carry float32 noise of the field's scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.apps.seismic import solver as jsol
from repro.apps.seismic import workflow as jwf
from repro.rts.jax_rts import JaxRTS
from repro_torch import api
from repro_torch.apps.seismic import solver as tsol
from repro_torch.apps.seismic import workflow as twf
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS

RTOL = 1e-4
SMALL = dict(nx=32, nt=60, seed=0, dv=25.0)
N_EVENTS = 8
COUNTERS = ("chain_carriers", "chain_links", "dag_carriers", "dag_links",
            "dispatches")


def _cfgs(**kw):
    return jsol.SeismicConfig(**kw), tsol.SeismicConfig(**kw)


def _field_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("nx,n_rec", [(32, 8), (48, 8), (64, 16), (128, 32)])
def test_receiver_indices_equal_jax(nx, n_rec):
    cfg_j, cfg_t = _cfgs(nx=nx, nz=nx, nt=10, n_receivers=n_rec)
    ref = np.asarray(jnp.linspace(4, cfg_j.nx - 5, cfg_j.n_receivers)
                     .astype(jnp.int32))
    assert np.array_equal(tsol.receiver_x(cfg_t).numpy(), ref)


def test_velocity_forward_misfit_and_gradient_match_jax():
    cfg_j, cfg_t = _cfgs(nx=32, nz=32, nt=60, n_receivers=8)
    v_j = jsol.make_velocity_model(cfg_j, "true", seed=1)
    v_t = tsol.make_velocity_model(cfg_t, "true", seed=1, device="cpu")
    assert np.array_equal(np.asarray(v_j), v_t.numpy())
    for sx in (8, 12, 23):
        obs_j = np.asarray(jsol.forward_simulation(v_j, sx, cfg_j))
        obs_t = tsol.forward_simulation(v_t, sx, cfg_t)
        assert obs_t.shape == (cfg_t.nt, cfg_t.n_receivers)
        _field_close(obs_t, obs_j)
        b_j = jsol.make_velocity_model(cfg_j, "background")
        b_t = tsol.make_velocity_model(cfg_t, "background", device="cpu")
        obs = torch.from_numpy(obs_j.copy())
        m_j = float(jsol.misfit(b_j, jnp.asarray(obs_j), sx, cfg_j))
        m_t = float(tsol.misfit(b_t, obs, sx, cfg_t))
        assert np.isclose(m_t, m_j, rtol=RTOL, atol=0)
        mg_j, g_j = jsol.misfit_and_grad(b_j, jnp.asarray(obs_j), sx, cfg_j)
        mg_t, g_t = tsol.misfit_and_grad(b_t, obs, sx, cfg_t)
        assert np.isclose(float(mg_t), float(mg_j), rtol=RTOL, atol=0)
        assert float(np.abs(np.asarray(g_j)).max()) > 0
        _field_close(g_t, g_j)


def test_forward_is_vmappable_over_the_source():
    _, cfg = _cfgs(nx=32, nz=32, nt=30, n_receivers=8)
    vel = tsol.make_velocity_model(cfg, "true", device="cpu")
    xs = torch.tensor([8, 12, 20, 23])
    batched = torch.func.vmap(
        lambda sx: tsol.forward_simulation(vel, sx, cfg))(xs)
    for sx, row in zip(xs.tolist(), batched):
        assert torch.equal(row, tsol.forward_simulation(vel, sx, cfg))


def test_adjoint_gradient_reduces_misfit():
    """One gradient step on the velocity model must reduce the misfit
    (``tests/test_apps.py``'s adjoint check, on the port)."""
    _, cfg = _cfgs(nx=48, nz=48, nt=90, n_receivers=8)
    v_true = tsol.make_velocity_model(cfg, "true", device="cpu")
    observed = tsol.forward_simulation(v_true, 24, cfg)
    v0 = tsol.make_velocity_model(cfg, "background", device="cpu")
    m0, g = tsol.misfit_and_grad(v0, observed, 24, cfg)
    assert float(g.abs().max()) > 0
    d = g / g.abs().max()
    assert any(float(tsol.misfit_and_grad(v0 - eps * d, observed, 24, cfg)[0])
               < float(m0) for eps in (1.0, 0.3, 0.1)), \
        "no step size along -grad reduced the misfit"


def _record_jax_rts(monkeypatch):
    made = []

    def recording_rts(**kw):
        made.append(JaxRTS(**kw))
        return made[-1]

    monkeypatch.setattr(jwf, "JaxRTS", recording_rts)
    return made


def _counters(stats_list):
    return {k: sum(s[k] for s in stats_list) for k in COUNTERS}


@pytest.mark.parametrize("run", ["run_misfit_chain", "run_misfit_ensemble"])
def test_gathered_sweeps_match_jax_with_equal_counters(run, monkeypatch):
    made = _record_jax_rts(monkeypatch)
    ref = getattr(jwf, run)(N_EVENTS, **SMALL)
    got = getattr(twf, run)(N_EVENTS, device="cpu", **SMALL)
    assert ref["all_done"] and got["all_done"]
    assert np.allclose(got["misfits"], ref["misfits"], rtol=RTOL, atol=0)
    assert np.isclose(got["total_misfit"], ref["total_misfit"], rtol=RTOL,
                      atol=0)
    stats = got["fusion_stats"]
    assert _counters([stats]) == _counters([r.fusion_stats for r in made])
    # forward → misfit → Σ (or the sweep → Σ) is one DAG carrier
    assert stats["dag_carriers"] == 1 and stats["dispatches"] == 1
    assert stats["scalar_fallback"] == 0 and stats["degraded"] == 0
    # the device sum equals the sum of the delivered per-source misfits
    assert np.isclose(got["total_misfit"], sum(got["misfits"]), rtol=RTOL,
                      atol=0)


def test_chain_alone_matches_jax_with_equal_counters():
    """The forward→misfit chain without its gather runs on the chain tier
    in both packages, with the same carriers, links and dispatches."""
    kw = dict(nx=32, nz=32, nt=60, seed=0, dv=25.0)
    jrts, trts = [], []

    def jfactory():
        jrts.append(JaxRTS(slot_oversubscribe=4))
        return jrts[-1]

    def tfactory():
        trts.append(TorchRTS(device="cpu", slot_oversubscribe=4))
        return trts[-1]

    import repro.api as japi
    ens_j = jwf.build_misfit_chain(N_EVENTS, **kw)
    res_j = japi.run(ens_j, resources=ResourceDescription(slots=4),
                     rts_factory=jfactory, timeout=120)
    ref = [float(np.asarray(s.out.result())) for s in ens_j.specs]
    ens_t = twf.build_misfit_chain(N_EVENTS, device="cpu", **kw)
    res_t = api.run(ens_t, resources=ResourceDescription(slots=4),
                    rts_factory=tfactory, timeout=120)
    got = [float(np.asarray(s.out.result())) for s in ens_t.specs]
    assert res_j.all_done and res_t.all_done
    res_j.close()
    res_t.close()
    assert np.allclose(got, ref, rtol=RTOL, atol=0)
    stats = trts[0].fusion_stats
    assert _counters([stats]) == _counters([r.fusion_stats for r in jrts])
    assert stats["chain_carriers"] >= 1
    assert stats["chain_links"] == 2 * stats["chain_carriers"]
    assert stats["scalar_fallback"] == 0 and stats["degraded"] == 0


@pytest.mark.parametrize("run", ["run_misfit_chain", "run_misfit_ensemble"])
def test_fused_matches_scalar_within_the_port(run):
    fused = getattr(twf, run)(N_EVENTS, device="cpu", **SMALL)
    scalar = getattr(twf, run)(N_EVENTS, device="cpu", fuse=False, **SMALL)
    assert fused["all_done"] and scalar["all_done"]
    assert scalar["fusion_stats"]["fused"] == 0
    assert np.allclose(fused["misfits"], scalar["misfits"], rtol=RTOL,
                       atol=0)
    assert np.isclose(fused["total_misfit"], scalar["total_misfit"],
                      rtol=RTOL, atol=0)


def test_forward_ensemble_with_injected_failures_completes():
    r = twf.run_forward_ensemble(n_events=4, concurrency=2,
                                 failure_rate=0.4, nx=40, nt=60,
                                 device="cpu")
    assert r["all_done"]
    assert r["attempts"] >= 4
