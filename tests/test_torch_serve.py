"""The port's serving layer on the CPU: every case of the JAX package's
``tests/test_serve.py`` (tenant isolation, cross-tenant continuous
batching, admission codes, fair share, cancel mid-hold, per-tenant
journals and resume, the in-process and socket round trips) on
``EnsembleService(device="cpu")`` over ``TorchRTS``; the parity of both
packages' services on the AnEn ``analog_values`` sweep; and the service's
refusal to build a CPU RTS when CUDA is asked for and absent."""

import time

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import states as st
from repro_torch.core.pst import register_executable
from repro_torch.core.results import STORE
from repro_torch.fusion import fusable
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.torch_rts import TorchRTS
from repro_torch.serve import (AdmissionController, AdmissionError,
                               EnsembleService, FairSharePolicy,
                               InProcessClient, ServiceDaemon, SocketClient,
                               TenantJournals, TenantQuota)


# --------------------------------------------------------------------------- #
# Kernels (module-level: resume-stable registration)
# --------------------------------------------------------------------------- #

@fusable()
def k_double(x):
    return torch.as_tensor(x, dtype=torch.float32) * 2.0


@fusable()
def k_slow(x):
    time.sleep(0.01)
    return torch.as_tensor(x, dtype=torch.float32) + 1.0


register_executable("serve_test_double", k_double)


def _value(v):
    return float(np.asarray(v).reshape(-1)[0])


def _sweep(base, n=8):
    return [{"x": float(base + i)} for i in range(n)]


def _service(**kwargs):
    kwargs.setdefault("serve_hold_s", 0.25)
    kwargs.setdefault("device", "cpu")
    return EnsembleService(**kwargs).start()


# --------------------------------------------------------------------------- #
# Device: the default service is the card's, never a quiet CPU one
# --------------------------------------------------------------------------- #

def test_default_service_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsembleService()
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsembleService(device="cuda:0")


def test_cpu_service_runs_on_a_cpu_torch_rts():
    svc = _service()
    try:
        h = svc.submit(api.ensemble(k_double, over=_sweep(0, 4), name="m"),
                       tenant="alice")
        assert h.wait(60) and h.succeeded()
        rts = svc.amgr.emgr.rts
        assert isinstance(rts, TorchRTS)
        assert rts.serve_hold_s == 0.25
        assert [d.type for d in rts._devices] == ["cpu"]
    finally:
        svc.stop()


# --------------------------------------------------------------------------- #
# Concurrent tenants: isolation + cross-tenant batching
# --------------------------------------------------------------------------- #

def test_identical_names_isolated_across_tenants():
    """Two tenants submit workflows with IDENTICAL task names concurrently;
    each reads back exactly its own values."""
    svc = _service()
    try:
        h1 = svc.submit(api.ensemble(k_double, over=_sweep(0), name="m"),
                        tenant="alice")
        h2 = svc.submit(api.ensemble(k_double, over=_sweep(100), name="m"),
                        tenant="bob")
        assert h1.wait(60) and h2.wait(60)
        assert h1.ns != h2.ns
        for i in range(8):
            assert _value(h1.results()[f"m-{i}"]) == 2.0 * i
            assert _value(h2.results()[f"m-{i}"]) == 2.0 * (100 + i)
    finally:
        svc.stop()


def test_cross_tenant_continuous_batching():
    """Four concurrent tenants' same-kernel sweeps pack into shared
    carriers: at least one dispatched carrier mixes >= 2 tenants, and the
    per-tenant fan-out accounting records the shared dispatches."""
    svc = _service()
    try:
        handles = [svc.submit(
            api.ensemble(k_double, over=_sweep(100 * t), name="m"),
            tenant=f"t{t}") for t in range(4)]
        for h in handles:
            assert h.wait(60)
        stats = svc.stats()
        assert stats["fusion"]["cross_tenant_carriers"] >= 1
        for t in range(4):
            ts = stats["tenants"][f"t{t}"]
            assert ts["shared_dispatches"] >= 1
            assert ts["completions"] == 8
        for t, h in enumerate(handles):
            for i in range(8):
                assert _value(h.results()[f"m-{i}"]) == 2.0 * (100 * t + i)
        # the serve hold's per-tenant queue wait reaches the metrics verb
        tenants = svc.metrics()["tenants"]
        for t in range(4):
            assert tenants[f"t{t}"]["queue_wait"].get("count", 0) >= 1
            assert tenants[f"t{t}"]["shared_carriers"] >= 1
    finally:
        svc.stop()


def test_admission_codes():
    quota = TenantQuota(max_in_flight_members=8, max_active=1)
    adm = AdmissionController(default_quota=quota, max_backlog_members=12)
    svc = _service(admission=adm, serve_hold_s=0.5)
    try:
        h = svc.submit(api.ensemble(k_slow, over=_sweep(0, 6), name="m"),
                       tenant="alice")
        with pytest.raises(AdmissionError) as e1:
            svc.submit(api.ensemble(k_slow, over=_sweep(0, 6), name="m2"),
                       tenant="alice")
        assert e1.value.code in ("member-quota", "workflow-backlog")
        with pytest.raises(AdmissionError) as e2:
            svc.submit(api.ensemble(k_slow, over=_sweep(0, 8), name="m"),
                       tenant="bob")
        assert e2.value.code == "service-backlog"
        assert h.wait(60)
        # quota refunded after completion: the same submission admits now
        h2 = svc.submit(api.ensemble(k_slow, over=_sweep(0, 6), name="m2"),
                        tenant="alice")
        assert h2.wait(60)
    finally:
        svc.stop()


def test_fair_share_no_starvation():
    """A heavy tenant's large backlog must not starve a light tenant."""
    policy = FairSharePolicy()
    policy.set_weight("heavy", 1.0)
    policy.set_weight("light", 1.0)
    svc = _service(fair_share=policy, serve_hold_s=0.05)
    try:
        heavy = [svc.submit(
            api.ensemble(k_slow, over=_sweep(100 * k, 16), name="m"),
            tenant="heavy") for k in range(3)]
        light = svc.submit(api.ensemble(k_slow, over=_sweep(0, 4), name="m"),
                           tenant="light")
        assert light.wait(60)
        for h in heavy:
            assert h.wait(60)
        stats = svc.stats()
        assert stats["tenants"]["light"]["completions"] == 4
        assert stats["tenants"]["heavy"]["completions"] == 48
    finally:
        svc.stop()


# --------------------------------------------------------------------------- #
# Cancellation: a canceled tenant must not disturb its batch neighbours
# --------------------------------------------------------------------------- #

def test_cancel_mid_hold_frees_only_that_tenant():
    """Cancel tenant A while its members are parked in the continuous-
    batching hold; tenant B's members (same hold, same fusion key) still
    flush and complete."""
    svc = _service(serve_hold_s=1.0)
    try:
        ha = svc.submit(api.ensemble(k_double, over=_sweep(0), name="m"),
                        tenant="alice")
        hb = svc.submit(api.ensemble(k_double, over=_sweep(100), name="m"),
                        tenant="bob")
        time.sleep(0.2)   # let both reach the RTS hold
        ha.cancel()
        assert ha.wait(30), "canceled submission must still finish"
        assert hb.wait(60), "neighbour tenant must be unaffected"
        for i in range(8):
            assert _value(hb.results()[f"m-{i}"]) == 2.0 * (100 + i)
        states = ha.task_states()
        assert all(s in (st.CANCELED, st.DONE) for s in states.values())
        assert any(s == st.CANCELED for s in states.values())
        canceled = [n for n, s in states.items() if s == st.CANCELED]
        for name in canceled:
            assert not STORE.has(ha.ns, name)
        hc = svc.submit(api.ensemble(k_double, over=_sweep(200), name="m"),
                        tenant="carol")
        assert hc.wait(60)
        assert _value(hc.results()["m-0"]) == 400.0
    finally:
        svc.stop()


def test_held_members_are_in_flight_and_cancel_stops_an_emptied_hold():
    """On the RTS itself: held members count as in flight; cancelling every
    held member empties the hold and stops its timer, so nothing runs."""
    done = []
    rts = TorchRTS(device="cpu", slot_oversubscribe=4, serve_hold_s=5.0)
    rts.set_callback(done.append)
    rts.start(ResourceDescription(slots=4))
    try:
        ens = api.ensemble(k_double, over=_sweep(0, 6), name="held")
        tasks = [t for p in api.compile(ens).pipelines
                 for s in p.stages for t in s.tasks]
        rts.submit(tasks)
        assert sorted(rts.in_flight()) == sorted(t.uid for t in tasks)
        assert len(rts._hold_timers) == 1
        rts.cancel([t.uid for t in tasks])
        assert rts.in_flight() == []
        assert not rts._held and not rts._hold_timers
        assert done == []
    finally:
        rts.stop()


# --------------------------------------------------------------------------- #
# Per-tenant journals: spill isolation + per-tenant resume
# --------------------------------------------------------------------------- #

def test_tenant_journal_and_spill_isolation(tmp_path):
    root = str(tmp_path / "serve-journal")
    tj = TenantJournals(root)
    ja = tj.register("wf.0001", "alice")
    tj.register("wf.0002", "bob")
    tj.transition(kind="task", uid="u1", name="m-0", frm="A", to="B",
                  ns="wf.0001")
    tj.transition(kind="task", uid="u2", name="m-0", frm="A", to="B",
                  ns="wf.0002")
    tj.transition(kind="task", uid="u3", name="svc", frm="A", to="B")
    tj.flush()
    ra = tj.replay_tenant("alice")
    rb = tj.replay_tenant("bob")
    assert ra["records"] == 1 and rb["records"] == 1
    assert ja.enabled and tj.enabled
    assert tj.tenant_spill_dir("alice") != tj.tenant_spill_dir("bob")
    assert tj.tenant_spill_dir("alice").startswith(root)
    evil = tj.tenant_spill_dir("../../etc")
    assert evil.startswith(root)
    assert tj.tenant_spill_dir("a/b") != tj.tenant_spill_dir("a_b")
    tj.close()


def test_killed_service_resume_restores_only_requesting_tenant(tmp_path):
    """Run two tenants to completion, tear the service down (journals
    survive), bring a fresh service up and resume ONE tenant: its completed
    tasks are skipped with results restored, and the other tenant's
    journal is untouched."""
    root = str(tmp_path / "serve-journal")
    svc = _service(journal_root=root)
    try:
        ha = svc.submit(api.ensemble(k_double, over=_sweep(0), name="m",
                                     fuse=False), tenant="alice")
        hb = svc.submit(api.ensemble(k_double, over=_sweep(100), name="m",
                                     fuse=False), tenant="bob")
        assert ha.wait(60) and hb.wait(60)
    finally:
        svc.stop()
    STORE.clear_namespace(ha.ns)
    STORE.clear_namespace(hb.ns)

    calls = []

    def probe(x):
        calls.append(x)
        return x * 2.0

    svc2 = _service(journal_root=root)
    try:
        h2 = svc2.submit(
            api.ensemble(probe, over=_sweep(0), name="m", fuse=False),
            tenant="alice", resume=True)
        assert h2.wait(60)
        states = h2.task_states()
        assert all(s == st.DONE for s in states.values())
        assert not calls, "resumed-DONE tasks must not re-execute"
        for i in range(8):
            assert _value(h2.results()[f"m-{i}"]) == 2.0 * i
        bob_replay = svc2.journals.replay_tenant("bob")
        assert ("task", "m-0") in bob_replay["state"]
    finally:
        svc2.stop()


def test_resume_is_per_tenant_not_global(tmp_path):
    """A tenant WITHOUT a journal history resumes nothing even when
    another tenant completed identically-named tasks."""
    root = str(tmp_path / "serve-journal")
    svc = _service(journal_root=root)
    try:
        ha = svc.submit(api.ensemble(k_double, over=_sweep(0), name="m",
                                     fuse=False), tenant="alice")
        assert ha.wait(60)
    finally:
        svc.stop()

    svc2 = _service(journal_root=root)
    try:
        hc = svc2.submit(
            api.ensemble(k_double, over=_sweep(50), name="m", fuse=False),
            tenant="carol", resume=True)
        assert hc.wait(60)
        for i in range(8):
            assert _value(hc.results()[f"m-{i}"]) == 2.0 * (50 + i)
    finally:
        svc2.stop()


# --------------------------------------------------------------------------- #
# Protocol: in-process and socket round-trips
# --------------------------------------------------------------------------- #

def test_in_process_client_round_trip():
    svc = _service()
    try:
        client = InProcessClient(svc)
        assert client.hello()["server"] == "repro-serve"
        h = client.submit("reg://serve_test_double", _sweep(0, 4),
                          tenant="alice", name="m")
        assert client.wait(h, timeout=60)
        results = client.result(h)
        assert results["m-1"] == pytest.approx(2.0)
        assert set(client.states(h).values()) == {st.DONE}
        stats = client.stats()
        assert stats["tenants"]["alice"]["completions"] == 4
    finally:
        svc.stop()


def test_socket_daemon_round_trip():
    svc = _service()
    daemon = ServiceDaemon(svc, port=0).start()
    try:
        with SocketClient("127.0.0.1", daemon.port) as c1, \
                SocketClient("127.0.0.1", daemon.port) as c2:
            assert c1.hello()["version"] == 1
            h1 = c1.submit("reg://serve_test_double", _sweep(0, 4),
                           tenant="alice", name="m")
            h2 = c2.submit("reg://serve_test_double", _sweep(100, 4),
                           tenant="bob", name="m")
            # handles are daemon-scoped, not connection-scoped
            assert c2.wait(h1, timeout=60) and c1.wait(h2, timeout=60)
            assert c1.result(h1)["m-0"] == pytest.approx(0.0)
            assert c1.result(h2)["m-0"] == pytest.approx(200.0)
            from repro_torch.serve.client import ServeRequestError
            svc.admission.register("caged", TenantQuota(max_active=0,
                                                        max_in_flight_members=1))
            with pytest.raises(ServeRequestError) as err:
                c1.submit("reg://serve_test_double", _sweep(0, 4),
                          tenant="caged")
            assert err.value.code == "member-quota"
    finally:
        daemon.stop()
        svc.stop()


# --------------------------------------------------------------------------- #
# The slice: both packages' services on the same AnEn sweeps
# --------------------------------------------------------------------------- #

ANEN_SMALL = dict(seed=0, ny=20, nx=20, n_hist=30, k=12)
N_MEMBERS, N_LOCS = 4, 16


def _anen_sweeps():
    """Two tenants' sweeps: 4 members of 16 distinct grid points each."""
    sweeps = {}
    for t, tenant in enumerate(("alice", "bob")):
        rng = np.random.default_rng(1000 + t)
        members = []
        for _ in range(N_MEMBERS):
            flat = rng.choice(ANEN_SMALL["ny"] * ANEN_SMALL["nx"], N_LOCS,
                              replace=False)
            members.append(np.stack(np.divmod(flat, ANEN_SMALL["nx"]),
                                    axis=1).tolist())
        sweeps[tenant] = members
    return sweeps


def _serve_sweeps(service, api_module, kernel, sweeps, extra):
    """Submit both tenants' sweeps concurrently; per-tenant values (in
    member order) and the service's stats."""
    service.start()
    try:
        handles = {}
        for tenant, members in sweeps.items():
            over = [dict(ANEN_SMALL, locations=locs, **extra)
                    for locs in members]
            handles[tenant] = service.submit(
                api_module.ensemble(kernel, over=over, name="av"),
                tenant=tenant)
        values = {}
        for tenant, h in handles.items():
            assert h.wait(120) and h.succeeded()
            res = h.results()
            values[tenant] = [np.asarray(res[f"av-{i}"], np.float64)
                              for i in range(N_MEMBERS)]
        return values, service.stats()
    finally:
        service.stop()


def test_anen_sweeps_match_the_jax_service():
    """Two tenants' seeded ``analog_values`` sweeps through the JAX
    package's service (its default JaxRTS on the CPU) and the port's
    (``device="cpu"``): each tenant's values agree within 1e-6, both
    services share at least one carrier across tenants, and both count the
    same completions per tenant."""
    from repro import api as japi
    from repro.apps.anen import workflow as jwf
    from repro.rts.base import ResourceDescription as JResources
    from repro.serve import EnsembleService as JaxService
    from repro_torch.apps.anen import workflow as twf

    sweeps = _anen_sweeps()
    jvals, jstats = _serve_sweeps(
        JaxService(resources=JResources(slots=4), serve_hold_s=0.25),
        japi, jwf.analog_values, sweeps, {})
    tvals, tstats = _serve_sweeps(
        EnsembleService(resources=ResourceDescription(slots=4),
                        serve_hold_s=0.25, device="cpu"),
        api, twf.analog_values, sweeps, {"device": "cpu"})
    for tenant in sweeps:
        for j, t in zip(jvals[tenant], tvals[tenant]):
            assert t.shape == (N_LOCS,) and np.isfinite(t).all()
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    assert jstats["fusion"]["cross_tenant_carriers"] >= 1
    assert tstats["fusion"]["cross_tenant_carriers"] >= 1
    for tenant in sweeps:
        assert (tstats["tenants"][tenant]["completions"]
                == jstats["tenants"][tenant]["completions"] == N_MEMBERS)
    assert tstats["fusion"]["scalar_fallback"] == 0
    assert tstats["fusion"]["degraded"] == 0
