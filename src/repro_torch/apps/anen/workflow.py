"""AUA (Adaptive Unstructured Analog) workflow under EnTK (§III-B, Fig. 11).

The iterative search is *described* on the declarative API
(:mod:`repro_torch.api`): each iteration is an :func:`~repro_torch.api.ensemble`
over location slices, and the unknown-length iteration sequence is an
:func:`~repro_torch.api.repeat_until` loop — which the compiler lowers onto
the ``post_exec``/append-listener machinery the paper describes (iteration
stages appended at runtime, never re-entering an HPC queue). Task
*results* (the computed analog values) flow between rounds through the
API's data-flow plumbing.

Two implementations are compared, as in Fig. 11:

* **random** — each iteration computes analogs at uniformly random new
  locations;
* **AUA** — each iteration interpolates the current estimate, measures its
  local gradient, and places new locations preferentially where the field
  changes fastest (fronts), steering the computation.

Runs go through :class:`~repro_torch.rts.torch_rts.TorchRTS` on ``device``
(CUDA unless the caller passes ``"cpu"``). Each round compiles, as in the
JAX package, to a fusable DAG (``analog_values → analog_refine → max``)
that runs as ONE carrier on the DAG tier: ``analog_values``' hand-batched
implementation is the entry node and launches the CUDA ``anen_distance``
kernel once, at the whole round's width; ``analog_refine`` and the masked
``max`` then run as one composed segment on the device. Given ``places``
(cards, or lanes of one card from
:func:`~repro_torch.device.virtual_devices`), a round at least
``shard_min_members`` members wide runs on the sharded tier: each place
launches the kernel once on its shard of the members.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import api
from ...core import AppManager, register_executable
from ...device import DeviceLike, device_name
from ...fusion import fusable, fusable_reduction
from ...fusion.handles import ArrayResult, to_host
from ...fusion.plans import DEFAULT_SHARD_MIN_MEMBERS
from ...rts.base import ResourceDescription
from ...rts.torch_rts import TorchRTS
from .anen import (AnEnConfig, compute_analogs, dataset_from_numpy,
                   gradient_magnitude, idw_interpolate, make_fields, rmse,
                   top_k)

_DATASETS: Dict[tuple, object] = {}
#: dataset key -> {"build_s": numpy build seconds, "upload_s": cast and
#: upload seconds}, recorded when the dataset is first made
DATASET_SECONDS: Dict[tuple, Dict[str, float]] = {}
_dataset_lock = threading.Lock()


def _dataset(seed: int, ny: int, nx: int, n_hist: int, device: str):
    """The device-resident dataset, built once per configuration and
    device and shared by every task of every run in the process."""
    key = (seed, ny, nx, n_hist, device)
    with _dataset_lock:
        if key not in _DATASETS:
            t0 = time.perf_counter()
            fields = make_fields(AnEnConfig(ny=ny, nx=nx, n_hist=n_hist,
                                            seed=seed))
            t1 = time.perf_counter()
            data = dataset_from_numpy(*fields, device=device)
            if data.hist_obs.is_cuda:
                torch.cuda.synchronize(data.hist_obs.device)
            DATASET_SECONDS[key] = {"build_s": t1 - t0,
                                    "upload_s": time.perf_counter() - t1}
            _DATASETS[key] = data
        return _DATASETS[key]


def _analog_values_batched(locations, *, seed: int, ny: int, nx: int,
                           n_hist: int, k: int, device: str):
    """Hand-batched implementation for the fusion engine: one dispatch for
    a whole micro-batch of members.

    ``locations`` is a (B, n, 2) integer tensor — B members' (possibly
    padded) location slices. The member axis folds into the location axis
    (every location is independent), the similarity matrix runs through
    the CUDA distance kernel (its plain version for CPU tensors), and the
    analog means unfold back to (B, n).
    """
    from ...kernels.anen_distance import anen_distance

    data = _dataset(seed, ny, nx, n_hist, device)
    b, n, _ = locations.shape
    flat = locations.reshape(b * n, 2).to(data.hist_obs.device).long()
    ys, xs = flat[:, 0], flat[:, 1]
    f_now = data.forecast_now[:, ys, xs]        # (V, B·n)
    f_h = data.hist_forecast[:, :, ys, xs]      # (H, V, B·n)
    o_h = data.hist_obs[:, ys, xs]              # (H, B·n)
    d2 = anen_distance(f_h, f_now)
    _, idx = top_k(-d2.T, k)                    # (B·n, k) most similar
    picked = torch.take_along_dim(o_h.T, idx, dim=1)
    return picked.mean(dim=1).reshape(b, n)


@fusable(static_argnames=("seed", "ny", "nx", "n_hist", "k", "device"),
         pad_argnames=("locations",), batched=_analog_values_batched)
def analog_values(locations: List[List[int]], seed: int = 0, ny: int = 48,
                  nx: int = 48, n_hist: int = 120, k: int = 12,
                  device: str = "cuda"):
    """EnTK task: analog predictions at a slice of locations — the fused
    AnEn member kernel. Scalar execution (a group below the fusion
    threshold, or ``fuse=False``) computes exactly the same values through
    :func:`compute_analogs`; fused execution batches congruent members into
    one dispatch with the CUDA distance kernel. ``device`` is the device
    name (``"cuda:0"``, ``"cpu"``): a static, JSON-able argument."""
    data = _dataset(seed, ny, nx, n_hist, device)
    locs = torch.as_tensor(np.asarray(locations), dtype=torch.long,
                           device=data.hist_obs.device)
    return compute_analogs(data, locs, k)


register_executable("analog_values", analog_values)


@fusable(static_argnames=("lo", "hi"), pad_argnames=("values",))
def analog_refine(values, lo: float = 0.0, hi: float = 1.0):
    """Second node of each round's DAG: bound the analog estimates to the
    historical observation range.

    Analog means are averages of observed values, so the clip is exactly
    the identity on well-formed inputs — it is a guard against corrupted
    history windows. On the DAG tier it runs under ``torch.func.vmap`` in
    the round's composed segment, its input the entry node's output carried
    on the device; ``values`` is then a tensor and the body does no host
    round-trip and no data-dependent branch.
    """
    if isinstance(values, ArrayResult):
        values = values.value
    if not isinstance(values, torch.Tensor):   # a host value on the scalar path
        values = torch.from_numpy(np.asarray(values, np.float32))
    return torch.clamp(values.to(torch.float32), lo, hi)


register_executable("analog_refine", analog_refine)


@fusable_reduction(kind="max")
def round_spread(values) -> float:
    """Round fan-in: the largest analog estimate of the round — a cheap
    convergence statistic (the adaptive criterion watches the estimate's
    dynamic range tighten as fronts get resolved).

    ``kind="max"`` makes the whole round a fusable DAG: on the DAG tier the
    reduction runs masked on the device over the refined member values, in
    the same segment as ``analog_refine`` (max is also safe over the
    engine's edge-replicated pad rows). Scalar execution runs this body."""
    return float(np.max([np.max(to_host(v)) for v in values]))


register_executable("round_spread", round_spread)


class _RoundNode(api.Node):
    """What :meth:`_SearchState.make_round` returns: the refine ensemble's
    member futures PLUS the round's spread reduction. The loop's check
    stage collects all of them (``absorb`` zips results against the round's
    location slices, so the trailing spread value is simply extra)."""

    def __init__(self, refine: api.Ensemble, spread) -> None:
        self.refine = refine
        self.spread = spread

    def futures(self):
        return list(self.refine.futures()) + list(self.spread.futures())


class _SearchState:
    """Shared state the adaptive post_exec hooks steer."""

    def __init__(self, method: str, seed: int, cfg: AnEnConfig,
                 per_iter: int, max_iters: int, n_tasks: int,
                 device: str, fuse: bool = True) -> None:
        self.method = method
        self.seed = seed
        self.cfg = cfg
        self.per_iter = per_iter
        self.max_iters = max_iters
        self.n_tasks = n_tasks
        self.device = device
        self.fuse = fuse
        self.rng = np.random.default_rng(seed + (0 if method == "aua"
                                                 else 10_000))
        self.locations: List[List[int]] = []
        self.values: List[float] = []
        self.errors: List[float] = []
        self.round_seconds: List[float] = []
        self._round_t0 = None
        self.iteration = 0
        self.data = _dataset(seed, cfg.ny, cfg.nx, cfg.n_hist, device)
        # bounds for the refine stage (the historical observation range):
        # plain floats, so they ride as static arguments
        self.obs_lo = float(self.data.hist_obs.min())
        self.obs_hi = float(self.data.hist_obs.max())
        # the location slices of the round in flight: member results come
        # back as bare value arrays (device-resident on the fused path), so
        # the search keeps the location bookkeeping host-side
        self._round_slices: List[List[List[int]]] = []

    # ---- location proposal ------------------------------------------------ #

    def _random_new(self, n: int) -> np.ndarray:
        taken = set(map(tuple, self.locations))
        out = []
        while len(out) < n:
            y = int(self.rng.integers(0, self.cfg.ny))
            x = int(self.rng.integers(0, self.cfg.nx))
            if (y, x) not in taken:
                taken.add((y, x))
                out.append([y, x])
        return np.asarray(out, np.int32)

    def _estimate(self) -> torch.Tensor:
        """IDW estimate of the field from every location computed so far."""
        dev = self.data.hist_obs.device
        locs = torch.as_tensor(self.locations, dtype=torch.int32, device=dev)
        vals = torch.as_tensor(self.values, dtype=torch.float32, device=dev)
        return idw_interpolate(locs, vals, self.cfg.ny, self.cfg.nx)

    def _adaptive_new(self, n: int) -> np.ndarray:
        """AUA refinement: greedy picks by error-indicator × spacing.

        priority(cell) = |∇ estimate| × dist²-to-nearest-sample — the
        classical adaptive-mesh criterion: refine where the field changes
        fast *and* the sampling is still coarse. Greedy selection with
        neighbourhood suppression avoids redundant clustering on the same
        front pixel. A quarter of the budget stays uniform (coverage of
        regions the current estimate cannot see yet).
        """
        n_explore = max(1, n // 4)
        n_exploit = n - n_explore
        explore = self._random_new(n_explore)
        ny, nx = self.cfg.ny, self.cfg.nx
        grad = to_host(gradient_magnitude(self._estimate())).astype(
            np.float64)
        # smear the indicator one cell so line-like fronts are 2-3 px wide
        grad = grad + 0.5 * (np.roll(grad, 1, 0) + np.roll(grad, -1, 0)
                             + np.roll(grad, 1, 1) + np.roll(grad, -1, 1))
        yy, xx = np.mgrid[0:ny, 0:nx]
        all_pts = (np.asarray(self.locations + explore.tolist())
                   if len(self.locations) else explore)
        d2 = self._nearest_d2(all_pts)
        picks = []
        pri = grad * d2
        for _ in range(n_exploit):
            flat = int(np.argmax(pri))
            py, px = flat // nx, flat % nx
            picks.append([py, px])
            nd2 = (yy - py) ** 2 + (xx - px) ** 2
            d2 = np.minimum(d2, nd2)
            pri = grad * d2
        return np.concatenate([explore, np.asarray(picks, np.int32)],
                              axis=0)

    def _nearest_d2(self, pts: np.ndarray) -> np.ndarray:
        """Squared distance from every cell to its nearest point of
        ``pts``, as float64. Computed on the dataset's device in chunks of
        points: the values are integers far below 2**53, so the minimum is
        exact and equals the reference's per-point numpy loop."""
        ny, nx = self.cfg.ny, self.cfg.nx
        dev = self.data.hist_obs.device
        yy = torch.arange(ny, device=dev, dtype=torch.int64)[:, None]
        xx = torch.arange(nx, device=dev, dtype=torch.int64)[None, :]
        p = torch.as_tensor(np.asarray(pts, np.int64), device=dev)
        best = torch.full((ny, nx), torch.iinfo(torch.int64).max,
                          dtype=torch.int64, device=dev)
        chunk = max(1, (1 << 24) // (ny * nx))
        for start in range(0, p.shape[0], chunk):
            py = p[start:start + chunk, 0][:, None, None]
            px = p[start:start + chunk, 1][:, None, None]
            d = (yy[None] - py) ** 2 + (xx[None] - px) ** 2
            best = torch.minimum(best, d.amin(dim=0))
        return to_host(best).astype(np.float64)

    def propose(self, n: int) -> np.ndarray:
        if self.method == "aua" and self.iteration > 0:
            return self._adaptive_new(n)
        return self._random_new(n)

    # ---- bookkeeping ------------------------------------------------------- #

    def absorb(self, results: List) -> None:
        """Fold one round's task results (analog values) into the estimate.

        ``results`` line up with the round's location slices by member
        index; each value may be a list, ndarray, tensor or a
        device-resident :class:`~repro_torch.fusion.ArrayResult`.
        """
        for slice_locs, r in zip(self._round_slices, results):
            if r is None:
                continue
            self.locations.extend(slice_locs)
            self.values.extend(to_host(r).tolist())
        self.errors.append(rmse(self._estimate(), self.data.truth))
        self.iteration += 1
        if self._round_t0 is not None:
            self.round_seconds.append(time.perf_counter() - self._round_t0)

    # ---- declarative description ------------------------------------------- #

    def make_round(self, ctx: api.LoopContext) -> api.Node:
        """One iteration: ``analog_values → analog_refine → max`` over
        location slices.

        ``ctx.results`` (the previous round's values) were absorbed by
        :meth:`converged` before this method runs, so proposals always see
        the up-to-date estimate — including on journal resume, where rounds
        replay in order through the same two hooks.
        """
        self._round_t0 = time.perf_counter()
        locs = self.propose(self.per_iter)
        slices = [sl for sl in np.array_split(locs, self.n_tasks)
                  if len(sl)]
        self._round_slices = [sl.tolist() for sl in slices]
        search = api.ensemble(
            analog_values,
            over=[{"seed": self.seed, "ny": self.cfg.ny, "nx": self.cfg.nx,
                   "n_hist": self.cfg.n_hist, "k": self.cfg.k,
                   "device": self.device,
                   "locations": sl.tolist()} for sl in slices],
            name=f"{self.method}-it{ctx.round}-{self.seed}",
            max_retries=1, fuse=self.fuse)
        refine = search.then(
            analog_refine,
            over=[{"lo": self.obs_lo, "hi": self.obs_hi} for _ in slices],
            name=f"{self.method}-it{ctx.round}-{self.seed}-ref",
            max_retries=1, fuse=self.fuse)
        spread = api.gather(
            refine, round_spread,
            name=f"{self.method}-it{ctx.round}-{self.seed}-spread")
        return _RoundNode(refine, spread)

    def converged(self, ctx: api.LoopContext) -> bool:
        """repeat_until predicate: absorb the finished round, then decide."""
        self.absorb(ctx.results)
        return self.iteration >= self.max_iters

    def as_loop(self) -> api.Loop:
        return api.repeat_until(
            self.converged, self.make_round,
            name=f"anen-{self.method}-{self.seed}",
            max_rounds=self.max_iters)


def _run(method: str, seed: int, *, ny: int, nx: int, n_hist: int,
         per_iter: int, max_iters: int, n_tasks: int, slots: int,
         timeout: float, fuse: bool = True,
         device: DeviceLike = None,
         places: Optional[Sequence[Any]] = None, shard: bool = True,
         shard_min_members: int = DEFAULT_SHARD_MIN_MEMBERS) -> Dict:
    dev = device_name(device)
    cfg = AnEnConfig(ny=ny, nx=nx, n_hist=n_hist, seed=seed)
    search = _SearchState(method, seed, cfg, per_iter, max_iters, n_tasks,
                          dev, fuse=fuse)
    rts_box: List[TorchRTS] = []

    def make_rts() -> TorchRTS:
        # the fused path: congruent analog members of one round batch into
        # a single dispatch on the device (fuse=False reproduces the
        # per-task scalar behaviour bit-for-bit)
        rts = TorchRTS(device=dev, devices=places, slot_oversubscribe=slots,
                       shard=shard, shard_min_members=shard_min_members)
        rts_box.append(rts)
        return rts

    amgr = AppManager(resources=ResourceDescription(slots=slots),
                      rts_factory=make_rts, heartbeat_interval=1.0)
    compiled = api.compile(search.as_loop(), name=f"anen-{method}-{seed}")
    amgr.workflow = compiled
    amgr.run(timeout=timeout)
    if compiled.hook_errors:
        raise RuntimeError(f"anen adaptive hooks failed: "
                           f"{compiled.hook_errors}")
    # everything we report lives in the search state; release the store
    # namespace so repeated runs (compare_methods sweeps) stay bounded
    compiled.close()
    stats = {k: sum(r.fusion_stats[k] for r in rts_box)
             for k in (rts_box[0].fusion_stats if rts_box else {})}
    return {"method": method, "seed": seed, "device": dev,
            "n_locations": len(search.locations),
            "rounds": search.iteration,
            "errors": search.errors, "final_rmse": search.errors[-1],
            "round_seconds": search.round_seconds,
            "values": search.values,
            "fusion_stats": stats,
            "all_done": amgr.all_done}


def run_adaptive(seed: int = 0, **kw) -> Dict:
    return _run("aua", seed, **_defaults(kw))


def run_random(seed: int = 0, **kw) -> Dict:
    return _run("random", seed, **_defaults(kw))


def _defaults(kw: Dict) -> Dict:
    out = dict(ny=48, nx=48, n_hist=120, per_iter=60, max_iters=5,
               n_tasks=4, slots=4, timeout=600.0)
    out.update(kw)
    return out


def compare_methods(repeats: int = 5, **kw) -> Dict:
    """Fig.-11 comparison: error distributions over repeated runs."""
    aua, rnd = [], []
    for r in range(repeats):
        aua.append(run_adaptive(seed=r, **kw)["final_rmse"])
        rnd.append(run_random(seed=r, **kw)["final_rmse"])
    return {
        "repeats": repeats,
        "aua_rmse": aua,
        "random_rmse": rnd,
        "aua_median": float(np.median(aua)),
        "random_median": float(np.median(rnd)),
        "aua_wins": int(sum(a < b for a, b in zip(aua, rnd))),
    }
