"""2-D acoustic full-waveform forward/adjoint solver in PyTorch.

Stands in for SPECFEM in the paper's tomography workflow (§III-A): the
physics is reduced (2-D acoustic, second-order FD leapfrog, absorbing-ish
damped boundaries) but the *workflow shape* is the paper's — per-earthquake
forward simulations producing seismograms at receiver arrays, a misfit
against observed data, and the adjoint gradient (here reverse-mode autograd
through the time loop, which is adjoint-state in reverse-mode form) feeding
an iterative velocity-model update.

The time loop is a Python loop of out-of-place tensor ops, so every
function stays ``torch.func.vmap``-able over ``source_x`` (the fused tiers
vmap the seismic member kernels over a batch of sources): the source
injection is a one-hot field, never an in-place write. Functions build
their tensors on the velocity model's device.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SeismicConfig:
    nx: int = 128
    nz: int = 128
    nt: int = 400
    dx: float = 10.0          # m
    dt: float = 1e-3          # s  (CFL: c_max·dt/dx < 1/√2)
    f0: float = 12.0          # Ricker peak frequency, Hz
    n_receivers: int = 32
    damp_width: int = 12
    damp_strength: float = 0.015


def make_velocity_model(cfg: SeismicConfig, kind: str = "true",
                        seed: int = 0, device: DeviceLike = None
                        ) -> torch.Tensor:
    """Layered background + (for 'true') ellipsoidal anomalies; float32 on
    ``device`` (CUDA unless the caller passes ``"cpu"``)."""
    z = np.linspace(0, 1, cfg.nz)[:, None]
    c = 1500.0 + 1200.0 * z + 0.0 * np.zeros((cfg.nz, cfg.nx))
    if kind == "true":
        rng = np.random.default_rng(seed)
        zz, xx = np.mgrid[0:cfg.nz, 0:cfg.nx]
        for _ in range(3):
            cz, cx = rng.uniform(0.3, 0.8) * cfg.nz, rng.uniform(
                0.2, 0.8) * cfg.nx
            rz, rx = rng.uniform(6, 14), rng.uniform(8, 20)
            blob = np.exp(-(((zz - cz) / rz) ** 2 + ((xx - cx) / rx) ** 2))
            c += rng.choice([-1, 1]) * 180.0 * blob
    return torch.from_numpy(c.astype(np.float32)).to(resolve_device(device))


def _ricker(cfg: SeismicConfig, device: torch.device) -> torch.Tensor:
    t = torch.arange(cfg.nt, device=device, dtype=torch.float32) * cfg.dt \
        - 1.2 / cfg.f0
    a = (math.pi * cfg.f0 * t) ** 2
    return (1 - 2 * a) * torch.exp(-a)


def _damping(cfg: SeismicConfig, device: torch.device) -> torch.Tensor:
    d = np.zeros((cfg.nz, cfg.nx))
    w = cfg.damp_width
    for i in range(w):
        val = cfg.damp_strength * ((w - i) / w) ** 2
        d[i, :] = np.maximum(d[i, :], val)
        d[-1 - i, :] = np.maximum(d[-1 - i, :], val)
        d[:, i] = np.maximum(d[:, i], val)
        d[:, -1 - i] = np.maximum(d[:, -1 - i], val)
    return torch.from_numpy(d.astype(np.float32)).to(device)


def receiver_x(cfg: SeismicConfig, device: DeviceLike = "cpu"
               ) -> torch.Tensor:
    """Receiver columns: a float32 linspace truncated to int, as the JAX
    solver takes them (its tests hold the two equal for the configs used)."""
    return torch.linspace(4, cfg.nx - 5, cfg.n_receivers,
                          dtype=torch.float32).to(torch.int64).to(device)


_HOST_BUILT: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_host_built_lock = threading.Lock()


def _host_built(cfg: SeismicConfig, dev: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The damping field and the receiver columns on ``dev``, copied from
    the host once per (config, device): a time loop then makes no host
    copy, so a CUDA graph can capture it."""
    key = (cfg, str(dev))
    with _host_built_lock:
        hit = _HOST_BUILT.get(key)
    if hit is not None:
        return hit
    built = (_damping(cfg, dev), receiver_x(cfg, dev))
    with _host_built_lock:
        return _HOST_BUILT.setdefault(key, built)


def forward_simulation(velocity: torch.Tensor, source_x,
                       cfg: SeismicConfig) -> torch.Tensor:
    """One 'earthquake': source at (src_z=2, source_x). Returns the
    seismogram (nt, n_receivers) recorded at depth 2."""
    dev = velocity.device
    src = _ricker(cfg, dev)
    damp, rec_x = _host_built(cfg, dev)
    c2dt2 = (velocity * cfg.dt) ** 2 / (cfg.dx ** 2)
    # the source position as a one-hot field: adding s_t * inject adds s_t
    # at (2, source_x) and exactly 0 elsewhere, out of place, so a batched
    # source_x under vmap needs no in-place indexed write
    rows = torch.arange(cfg.nz, device=dev)[:, None] == 2
    cols = torch.arange(cfg.nx, device=dev)[None, :] == \
        torch.as_tensor(source_x, device=dev)
    inject = (rows & cols).to(torch.float32)

    def laplacian(u):
        return (-4.0 * u
                + torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
                + torch.roll(u, 1, 1) + torch.roll(u, -1, 1))

    u_prev = torch.zeros((cfg.nz, cfg.nx), dtype=torch.float32, device=dev)
    u = torch.zeros_like(u_prev)
    recs = []
    for t in range(cfg.nt):
        u_next = ((2.0 - damp) * u - (1.0 - damp) * u_prev
                  + c2dt2 * laplacian(u))
        u_next = u_next + src[t] * inject
        recs.append(u_next[2][rec_x])
        u_prev, u = u, u_next
    return torch.stack(recs)


def misfit(velocity: torch.Tensor, observed: torch.Tensor, source_x,
           cfg: SeismicConfig) -> torch.Tensor:
    """L2 waveform misfit for one source."""
    synth = forward_simulation(velocity, source_x, cfg)
    return 0.5 * torch.sum((synth - observed) ** 2)


def misfit_and_grad(velocity: torch.Tensor, observed: torch.Tensor,
                    source_x, cfg: SeismicConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(misfit, d misfit / d velocity): the adjoint gradient by reverse-mode
    autograd through the time loop."""
    v = velocity.detach().requires_grad_(True)
    with torch.enable_grad():
        m = misfit(v, observed, source_x, cfg)
        (g,) = torch.autograd.grad(m, v)
    return m.detach(), g
