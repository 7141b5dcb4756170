"""Analog Ensemble (AnEn) numerics in PyTorch.

Monache-style analog forecasting: for a target time and location, find the
``k`` historical forecasts most similar to the current forecast (similarity
over multiple variables) and average their verified observations. The
paper's AUA contribution is *where* to compute analogs: adaptively
concentrating locations where the field has sharp gradients instead of
sampling uniformly (§III-B, Fig. 11).

Synthetic NAM-like dataset: a truth field with smooth structure plus sharp
fronts; historical forecast/observation pairs share a stationary,
spatially-correlated error process, so analog search is genuinely
informative. The fields are built with numpy exactly as the JAX package
builds them and cast to float32 only at the end (:func:`dataset_from_numpy`),
so both packages hold bit-identical data for one configuration.

Top-k selections break ties toward the lower index, as ``jax.lax.top_k``
does (:func:`top_k`): on the integer grid, IDW distances tie often, and
``torch.topk`` gives no such order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...kernels.anen_distance import anen_distance_plain

# grid rows per IDW chunk are sized so one chunk's (rows, n) distance
# matrix and its int64 sort indices stay near this many elements
_IDW_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class AnEnConfig:
    ny: int = 64
    nx: int = 64
    n_hist: int = 200        # historical forecast/observation pairs
    n_vars: int = 3          # forecast variables entering the similarity
    k: int = 12              # analogs averaged
    seed: int = 0


class AnEnData(NamedTuple):
    truth: torch.Tensor          # (ny, nx) — verification field O_now
    forecast_now: torch.Tensor   # (n_vars, ny, nx)
    hist_forecast: torch.Tensor  # (n_hist, n_vars, ny, nx)
    hist_obs: torch.Tensor       # (n_hist, ny, nx)


def _smooth_noise(rng, shape, scale: int) -> np.ndarray:
    """Cheap spatially-correlated noise: upsampled coarse white noise."""
    coarse = rng.standard_normal((shape[0] // scale + 2,
                                  shape[1] // scale + 2))
    up = np.kron(coarse, np.ones((scale, scale)))
    out = up[:shape[0], :shape[1]]
    # light box blur
    for _ in range(2):
        out = 0.25 * (np.roll(out, 1, 0) + np.roll(out, -1, 0)
                      + np.roll(out, 1, 1) + np.roll(out, -1, 1))
    return out


def make_fields(cfg: AnEnConfig) -> Tuple[np.ndarray, ...]:
    """The dataset's fields in float64 numpy: ``(truth, forecast_now,
    hist_forecast, hist_obs)`` — the JAX package's construction, step for
    step, before its final float32 cast."""
    rng = np.random.default_rng(cfg.seed)
    ny, nx = cfg.ny, cfg.nx
    yy, xx = np.mgrid[0:ny, 0:nx] / max(ny, nx)
    # truth: smooth waves + two sharp fronts (the AUA refinement targets)
    base = (np.sin(2.5 * np.pi * xx) * np.cos(1.5 * np.pi * yy)
            + 0.5 * np.sin(4 * np.pi * (xx + yy)))
    front = (np.tanh(18 * (yy - 0.45 - 0.18 * np.sin(3 * np.pi * xx)))
             + 0.7 * np.tanh(24 * (xx - 0.7 + 0.1 * np.cos(2 * np.pi * yy))))
    # front-dominated, as in the paper's temperature maps: "the highest
    # resolution of the analogs is required only at specific regions,
    # where drastic gradient changes occur"
    truth = 0.35 * base + 2.2 * front

    def day_field(t: int) -> np.ndarray:
        season = 0.6 * np.sin(2 * np.pi * t / 73.0)
        wobble = _smooth_noise(np.random.default_rng(cfg.seed + 100 + t),
                               (ny, nx), 8) * 0.35
        return truth + season + wobble

    hist_obs = np.stack([day_field(t) for t in range(cfg.n_hist)])
    # forecast error process: stationary spatially-correlated bias + noise
    bias = _smooth_noise(rng, (ny, nx), 16) * 0.5

    def forecast_of(obs, t):
        r = np.random.default_rng(cfg.seed + 500 + t)
        err = bias + _smooth_noise(r, (ny, nx), 8) * 0.3
        f0 = obs + err
        # extra predictor variables: shifted/scaled views with their own noise
        f1 = 0.8 * obs + 0.3 + _smooth_noise(r, (ny, nx), 8) * 0.25
        f2 = np.roll(obs, 2, axis=1) + _smooth_noise(r, (ny, nx), 8) * 0.3
        return np.stack([f0, f1, f2][:3])

    hist_forecast = np.stack(
        [forecast_of(hist_obs[t], t) for t in range(cfg.n_hist)])
    obs_now = day_field(cfg.n_hist + 13)
    forecast_now = forecast_of(obs_now, cfg.n_hist + 13)
    return obs_now, forecast_now, hist_forecast, hist_obs


def dataset_from_numpy(truth, forecast_now, hist_forecast, hist_obs,
                       device: DeviceLike = None) -> AnEnData:
    """The port's device-resident dataset from numpy fields (float64 from
    :func:`make_fields`, or the JAX package's float32 arrays): each field
    is cast to float32 on the host and uploaded to ``device``."""
    dev = resolve_device(device)

    def up(a) -> torch.Tensor:
        host = np.ascontiguousarray(np.asarray(a), dtype=np.float32)
        if not host.flags.writeable:   # a read-only view (e.g. of a jax array)
            host = host.copy()
        return torch.from_numpy(host).to(dev)

    return AnEnData(truth=up(truth), forecast_now=up(forecast_now),
                    hist_forecast=up(hist_forecast), hist_obs=up(hist_obs))


def make_dataset(cfg: AnEnConfig, device: DeviceLike = None) -> AnEnData:
    return dataset_from_numpy(*make_fields(cfg), device=device)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, equal values in ascending index order — ``jax.lax.top_k``'s
    order, from a stable descending sort."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def compute_analogs(data: AnEnData, locations: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """AnEn prediction at ``locations`` (n, 2) integer (y, x) indices.

    similarity(h, p) = Σ_vars (F_now[v,p] − F_hist[h,v,p])²  (lower is more
    similar); prediction = mean of the k most similar historical
    observations at p. The distance is the plain version of the CUDA
    kernel, so this scalar path and the fused path agree bit for bit.
    """
    ys, xs = locations[:, 0].long(), locations[:, 1].long()
    f_now = data.forecast_now[:, ys, xs]            # (V, n)
    f_h = data.hist_forecast[:, :, ys, xs]          # (H, V, n)
    o_h = data.hist_obs[:, ys, xs]                  # (H, n)
    d2 = anen_distance_plain(f_h, f_now)            # (H, n)
    _, idx = top_k(-d2.T, k)                        # (n, k) most similar
    picked = torch.take_along_dim(o_h.T, idx, dim=1)
    return picked.mean(dim=1)                       # (n,)


def idw_interpolate(locations: torch.Tensor, values: torch.Tensor,
                    ny: int, nx: int, power: float = 2.0,
                    k_nearest: int = 8, eps: float = 1e-6) -> torch.Tensor:
    """k-nearest inverse-distance interpolation onto the full grid.

    Restricting to the nearest ``k`` samples (the unstructured-grid
    behaviour of the paper's implementation) is what makes *local*
    refinement effective: far-away samples cannot wash out a freshly
    refined front. The (grid, samples) distance matrix is built in row
    chunks — every grid point is independent, so chunking is exact.
    """
    dev = values.device
    ly = locations[:, 0].to(dev, torch.float32)
    lx = locations[:, 1].to(dev, torch.float32)
    n = ly.shape[0]
    k = min(k_nearest, n)
    grid = ny * nx
    rows = max(1, _IDW_CHUNK_ELEMS // max(1, n))
    flat = torch.arange(grid, device=dev)
    out = torch.empty(grid, dtype=torch.float32, device=dev)
    for start in range(0, grid, rows):
        g = flat[start:start + rows]
        gy = torch.div(g, nx, rounding_mode="floor").to(torch.float32)
        gx = torch.remainder(g, nx).to(torch.float32)
        d2 = ((gy[:, None] - ly[None]) ** 2
              + (gx[:, None] - lx[None]) ** 2)      # (rows, n)
        neg_d2, idx = top_k(-d2, k)                 # (rows, k) nearest
        w = 1.0 / ((-neg_d2) ** (power / 2) + eps)
        vals = values[idx]                           # (rows, k)
        out[start:start + rows] = (w * vals).sum(dim=1) / w.sum(dim=1)
    return out.reshape(ny, nx)


def rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a - b) ** 2)))


def gradient_magnitude(field: torch.Tensor) -> torch.Tensor:
    gy = torch.abs(torch.roll(field, -1, 0) - field)
    gx = torch.abs(torch.roll(field, -1, 1) - field)
    return gy + gx
