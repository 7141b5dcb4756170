"""Seismic forward-ensemble workflow under EnTK (paper §IV-C.1, Fig. 10).

Each task forward-simulates one earthquake (one source position) on the
current velocity model. The scale experiment varies the *concurrency*
(pilot slots) for a fixed ensemble and injects failures at high concurrency
— reproducing the paper's observation that reducing concurrency eliminated
failures while EnTK's resubmission transparently completed the failed tasks
(157 attempted for 128 nominal at 2⁵ concurrency in the paper).

The misfit sweeps run on :class:`~repro_torch.rts.torch_rts.TorchRTS`:
``forward_trial → trial_misfit`` is a 2-link elementwise chain (the chain
tier composes both links, the seismograms staying on the device), and with
the ``total_misfit`` sum gather it is a fusable DAG (one DAG carrier, the
sum reduced on the device). Every member kernel takes a static ``device``
argument and defaults to CUDA. Given ``places`` (cards, or lanes of one
card from :func:`~repro_torch.device.virtual_devices`), a sweep at least
``shard_min_members`` wide runs on the sharded tier: the DAG's member axis
split over the places, its sum combined from their partials.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import api
from ...core import AppManager, Pipeline, Stage, Task, register_executable
from ...device import DeviceLike, device_name
from ...fusion import fusable, fusable_reduction
from ...fusion.handles import to_host
from ...fusion.plans import DEFAULT_SHARD_MIN_MEMBERS
from ...rts.base import ResourceDescription
from ...rts.local import LocalRTS
from ...rts.torch_rts import TorchRTS
from .solver import SeismicConfig, forward_simulation, make_velocity_model, misfit

_CACHE: Dict[tuple, torch.Tensor] = {}
_cache_lock = threading.Lock()


def _velocity(kind: str, cfg: SeismicConfig, seed: int, device: str
              ) -> torch.Tensor:
    """The velocity model, built once per (kind, config, seed, device).

    Built from numpy, so even a first call inside a ``vmap`` of a member
    kernel makes a plain tensor; a functorch-wrapped value would be valid
    only inside that transform, and is returned without being cached."""
    key = (kind, cfg, seed, device)
    with _cache_lock:
        hit = _CACHE.get(key)
    if hit is not None:
        return hit
    vel = make_velocity_model(cfg, kind, seed=seed, device=device)
    if torch._C._functorch.is_functorch_wrapped_tensor(vel):
        return vel
    with _cache_lock:
        return _CACHE.setdefault(key, vel)


def simulate_earthquake(source_x: int, nx: int = 96, nz: int = 96,
                        nt: int = 220, seed: int = 0,
                        device: str = "cuda") -> Dict[str, float]:
    """EnTK task executable: one forward simulation; returns summary stats
    (the seismogram itself would be staged out in production)."""
    cfg = SeismicConfig(nx=nx, nz=nz, nt=nt)
    vel = _velocity("true", cfg, seed, device)
    seis = forward_simulation(vel, source_x, cfg)
    return {"source_x": int(source_x),
            "energy": float((to_host(seis).astype(np.float64) ** 2).sum())}


register_executable("simulate_earthquake", simulate_earthquake)


@fusable(static_argnames=("nx", "nz", "nt", "seed", "dv", "device"))
def eval_misfit(source_x: int, nx: int = 64, nz: int = 64, nt: int = 120,
                seed: int = 0, dv: float = 0.0, device: str = "cuda"):
    """EnTK task: the misfit of a trial (smooth background + ``dv``)
    velocity model against the true model's data for one earthquake — the
    fused seismic member kernel of the tomography workflow's evaluation
    sweep. ``source_x`` varies per member, so a fused micro-batch runs the
    whole source ensemble (observed-data forward + trial forward + misfit)
    as one vmapped time loop over (B, nz, nx) wavefields.
    """
    cfg = SeismicConfig(nx=nx, nz=nz, nt=nt)
    vel_true = _velocity("true", cfg, seed, device)
    vel_trial = _velocity("init", cfg, seed, device) + dv
    observed = forward_simulation(vel_true, source_x, cfg)
    return misfit(vel_trial, observed, source_x, cfg)


register_executable("eval_misfit", eval_misfit)


@fusable(static_argnames=("nx", "nz", "nt", "seed", "dv", "device"))
def forward_trial(source_x: int, nx: int = 64, nz: int = 64, nt: int = 120,
                  seed: int = 0, dv: float = 0.0, device: str = "cuda"):
    """Chain link 1: the trial model's synthetic seismogram for one source.

    Split out of :func:`eval_misfit` so the evaluation sweep becomes an
    elementwise forward→misfit *chain*: per member the forward wavefield
    (the expensive link) hands its ``(nt, n_receivers)`` seismogram to the
    misfit link on the device — under chain fusion the whole sweep runs
    both links as composed batched dispatches on one lease.
    """
    cfg = SeismicConfig(nx=nx, nz=nz, nt=nt)
    vel_trial = _velocity("init", cfg, seed, device) + dv
    return forward_simulation(vel_trial, source_x, cfg)


register_executable("forward_trial", forward_trial)


@fusable(static_argnames=("nx", "nz", "nt", "seed", "device"))
def trial_misfit(synthetic, source_x: int = 0, nx: int = 64, nz: int = 64,
                 nt: int = 120, seed: int = 0, device: str = "cuda"):
    """Chain link 2: L2 misfit of a trial seismogram against the observed
    data for its source (the observed forward is recomputed from the true
    model, exactly as :func:`eval_misfit` does — the two-link chain's
    values match the single-kernel sweep to float precision)."""
    cfg = SeismicConfig(nx=nx, nz=nz, nt=nt)
    vel_true = _velocity("true", cfg, seed, device)
    observed = forward_simulation(vel_true, source_x, cfg)
    synthetic = torch.as_tensor(synthetic, dtype=torch.float32,
                                device=observed.device)
    return 0.5 * torch.sum((synthetic - observed) ** 2)


register_executable("trial_misfit", trial_misfit)


@fusable_reduction(kind="sum")
def total_misfit(values: List) -> float:
    """Gather: the ensemble objective Σ_sources misfit(source).

    ``@fusable_reduction(kind="sum")`` lets ``api.compile`` fold this
    fan-in into the sweep's ``_fusion_dag`` plan: the whole forward →
    misfit → Σ aggregation becomes one DAG carrier with the sum reduced on
    the device, while the scalar body runs everywhere fusion is off."""
    return float(np.sum([to_host(v) for v in values]))


def _sources(n_events: int, nx: int) -> np.ndarray:
    return np.linspace(8, nx - 9, n_events).astype(int)


def build_misfit_ensemble(n_events: int, *, nx: int = 64, nz: int = 64,
                          nt: int = 120, seed: int = 0, dv: float = 0.0,
                          max_retries: int = 0, fuse: bool = True,
                          device: DeviceLike = None) -> api.Ensemble:
    """The misfit-evaluation sweep as a declarative (fusible) ensemble."""
    dev = device_name(device)
    return api.ensemble(
        eval_misfit,
        over=[{"source_x": int(sx), "nx": nx, "nz": nz, "nt": nt,
               "seed": seed, "dv": dv, "device": dev}
              for sx in _sources(n_events, nx)],
        name=f"misfit-{seed}", max_retries=max_retries, fuse=fuse)


def build_misfit_chain(n_events: int, *, nx: int = 64, nz: int = 64,
                       nt: int = 120, seed: int = 0, dv: float = 0.0,
                       max_retries: int = 0, fuse: bool = True,
                       device: DeviceLike = None) -> api.Ensemble:
    """The misfit sweep as a 2-link forward→misfit chain (one member per
    earthquake source): ``api.compile`` detects the elementwise link and
    TorchRTS runs each micro-batch through BOTH links as one composed
    dispatch, the per-source seismograms never leaving the device."""
    dev = device_name(device)
    xs = _sources(n_events, nx)
    forward = api.ensemble(
        forward_trial,
        over=[{"source_x": int(sx), "nx": nx, "nz": nz, "nt": nt,
               "seed": seed, "dv": dv, "device": dev} for sx in xs],
        name=f"forward-{seed}", max_retries=max_retries, fuse=fuse)
    return forward.then(
        trial_misfit,
        over=[{"source_x": int(sx), "nx": nx, "nz": nz, "nt": nt,
               "seed": seed, "device": dev} for sx in xs],
        name=f"misfit-chain-{seed}", max_retries=max_retries, fuse=fuse)


def _run_gathered(ens: api.Ensemble, objective, slots: int, device: str,
                  timeout: float,
                  places: Optional[Sequence[Any]] = None,
                  rts_kw: Optional[Dict[str, Any]] = None,
                  **run_kw) -> Dict:
    rts_box: List[TorchRTS] = []

    def make_rts() -> TorchRTS:
        rts_box.append(TorchRTS(device=device, devices=places,
                                slot_oversubscribe=slots, **(rts_kw or {})))
        return rts_box[-1]

    t0 = time.time()
    result = api.run(objective, resources=ResourceDescription(slots=slots),
                     rts_factory=make_rts, timeout=timeout, **run_kw)
    elapsed = time.time() - t0
    out = {
        "all_done": result.all_done,
        "total_misfit": objective.out.result(),
        "misfits": [float(to_host(s.out.result())) for s in ens.specs],
        "wallclock_s": elapsed,
        "fusion_stats": {k: sum(r.fusion_stats[k] for r in rts_box)
                         for k in (rts_box[0].fusion_stats
                                   if rts_box else {})},
    }
    result.close()
    return out


def run_misfit_chain(n_events: int, slots: int = 4, *, nx: int = 64,
                     nt: int = 120, seed: int = 0, dv: float = 0.0,
                     fuse: bool = True, chain: bool = True,
                     timeout: float = 600.0,
                     device: DeviceLike = None,
                     places: Optional[Sequence[Any]] = None,
                     shard: bool = True,
                     shard_min_members: int = DEFAULT_SHARD_MIN_MEMBERS
                     ) -> Dict:
    """Evaluate the forward→misfit→Σ sweep on the TorchRTS data plane.

    ``chain=False`` runs the identical 2-stage description per-stage-fused;
    ``fuse=False`` runs it member-per-task — the parity baselines. With
    ``places`` the RTS's inventory is those places, and a sweep at least
    ``shard_min_members`` wide shards its DAG across them; ``shard=False``
    pins it to one device."""
    dev = device_name(device)
    ens = build_misfit_chain(n_events, nx=nx, nz=nx, nt=nt, seed=seed,
                             dv=dv, fuse=fuse, device=dev)
    objective = api.gather(ens, total_misfit, name=f"total-chain-{seed}")
    out = _run_gathered(ens, objective, slots, dev, timeout, places=places,
                        rts_kw={"shard": shard,
                                "shard_min_members": shard_min_members},
                        chain=chain, shard=shard)
    out.update(n_events=n_events, fused=fuse, chained=chain)
    return out


def run_misfit_ensemble(n_events: int, slots: int = 4, *, nx: int = 64,
                        nt: int = 120, seed: int = 0, dv: float = 0.0,
                        fuse: bool = True, timeout: float = 600.0,
                        device: DeviceLike = None,
                        places: Optional[Sequence[Any]] = None,
                        shard: bool = True,
                        shard_min_members: int = DEFAULT_SHARD_MIN_MEMBERS
                        ) -> Dict:
    """Evaluate the source-ensemble misfit on the fused TorchRTS path.

    ``fuse=False`` runs the identical description member-per-task — the
    scalar baseline the parity tests compare against. ``places`` and
    ``shard_min_members`` are :func:`run_misfit_chain`'s; ``shard=False``
    keeps per-device micro-batches on a multi-place inventory (a single
    place is unaffected)."""
    dev = device_name(device)
    ens = build_misfit_ensemble(n_events, nx=nx, nz=nx, nt=nt, seed=seed,
                                dv=dv, fuse=fuse, device=dev)
    objective = api.gather(ens, total_misfit, name=f"total-misfit-{seed}")
    out = _run_gathered(ens, objective, slots, dev, timeout, places=places,
                        rts_kw={"shard": shard,
                                "shard_min_members": shard_min_members},
                        shard=shard)
    out.update(n_events=n_events, fused=fuse)
    return out


def build_forward_ensemble(n_events: int, *, nx: int = 96, nz: int = 96,
                           nt: int = 220, max_retries: int = 3,
                           device: DeviceLike = None) -> Pipeline:
    dev = device_name(device)
    pipe = Pipeline("seismic-forward")
    st = Stage("forward-simulations")
    for i, sx in enumerate(_sources(n_events, nx)):
        st.add_tasks(Task(
            name=f"eq{i:03d}", executable="reg://simulate_earthquake",
            kwargs={"source_x": int(sx), "nx": nx, "nz": nz, "nt": nt,
                    "device": dev},
            max_retries=max_retries, duration_hint=1.0))
    pipe.add_stages(st)
    return pipe


def run_forward_ensemble(n_events: int, concurrency: int,
                         failure_rate: float = 0.0, seed: int = 0,
                         nx: int = 96, nt: int = 220,
                         timeout: float = 600.0,
                         device: DeviceLike = None):
    """Fig.-10 cell: ``n_events`` forward sims on ``concurrency`` slots.

    ``failure_rate``: probability a task attempt fails (models the
    high-concurrency filesystem-overload failures of the paper); EnTK
    resubmits within each task's retry budget.
    """
    dev = device_name(device)
    rng = np.random.default_rng(seed)
    attempts: Dict[str, int] = {}

    def injector(task) -> bool:
        attempts[task.name] = attempts.get(task.name, 0) + 1
        return bool(rng.random() < failure_rate)

    amgr = AppManager(
        resources=ResourceDescription(slots=concurrency),
        rts_factory=lambda: LocalRTS(fault_injector=injector))
    amgr.workflow = [build_forward_ensemble(n_events, nx=nx, nz=nx, nt=nt,
                                            device=dev)]
    t0 = time.time()
    amgr.run(timeout=timeout)
    elapsed = time.time() - t0
    return {
        "n_events": n_events,
        "concurrency": concurrency,
        "failure_rate": failure_rate,
        "all_done": amgr.all_done,
        "task_execution_s": amgr.prof.totals().get("task_execution", 0.0),
        "wallclock_s": elapsed,
        "attempts": sum(attempts.values()),
    }
