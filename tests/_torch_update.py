"""Checks that one AdamW step of ``make_train_step`` reached every
parameter leaf: the moments against a reference, and each parameter
written from its own moments. No JAX here: the card tests import it too.

At step 1 the bias-corrected moments are the clipped gradient
(m̂ = m / (1 - b1)) and its magnitude (√v̂ = |g|), so holding them leaf by
leaf holds each leaf's gradient where it was stored, at the gradient's
own tolerance. The parameters themselves move by about ±lr at step 1
(lr 3e-6, the warm-up's first), which a tolerance on the parameters
cannot tell from no move at all; instead each leaf is held to
p0 - lr (m̂ / (√v̂ + eps) + wd p0) from its own moments, within two f32
spacings of p (the rounding of the in-place update), far below lr.
"""

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWConfig


def named_leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [item for key in sorted(tree)
            for item in named_leaves(tree[key], f"{prefix}/{key}")]


def as_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def moment_estimates(opt, cfg: AdamWConfig = AdamWConfig()):
    """{path: (m̂, √v̂)} of an AdamW state, as float64."""
    t = int(opt["step"])
    bc1, bc2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t
    vs = dict(named_leaves(opt["v"]))
    return {path: (as_f64(m) / bc1, np.sqrt(as_f64(vs[path]) / bc2))
            for path, m in named_leaves(opt["m"])}


def assert_moments_close(opt, want_opt, tol):
    """m̂ and √v̂ element by element against a reference's (JAX's)."""
    got, want = moment_estimates(opt), moment_estimates(want_opt)
    assert int(opt["step"]) == int(want_opt["step"])
    assert sorted(got) == sorted(want)
    for path, (m, v) in got.items():
        np.testing.assert_allclose(m, want[path][0], err_msg=f"m̂ {path}",
                                   **tol)
        np.testing.assert_allclose(v, want[path][1], err_msg=f"√v̂ {path}",
                                   **tol)


def moments_rel_err(opt, want_opt) -> float:
    """The largest leaf-wise ‖got - want‖ / ‖want‖ of m̂ and √v̂ (a leaf
    with no gradient on both sides counts 0)."""
    got, want = moment_estimates(opt), moment_estimates(want_opt)
    assert sorted(got) == sorted(want)
    worst = 0.0
    for path, pair in got.items():
        for a, b in zip(pair, want[path]):
            diff, norm = np.linalg.norm(a - b), np.linalg.norm(b)
            worst = max(worst, diff / norm if norm else float(diff > 0))
    return worst


def update_err(before, params, opt, lr: float,
               cfg: AdamWConfig = AdamWConfig()) -> float:
    """The largest |p - (p0 - lr (m̂ / (√v̂ + eps) + wd p0))| over every
    element, in units of its tolerance (two f32 spacings of p, plus 1e-4
    lr for the f32 arithmetic of the update): at most 1 when every leaf
    was written from its own moments."""
    est = moment_estimates(opt, cfg)
    before = dict(named_leaves(before))
    worst = 0.0
    for path, p in named_leaves(params):
        p0, p1 = as_f64(before[path]), as_f64(p)
        m, v = est[path]
        want = p0 - lr * (m / (v + cfg.eps) + cfg.weight_decay * p0)
        scale = np.maximum(np.abs(p0), np.abs(p1)).astype(np.float32)
        tol = 2 * np.spacing(scale).astype(np.float64) + 1e-4 * lr
        worst = max(worst, float(np.max(np.abs(p1 - want) / tol)))
    return worst


def assert_update_written(before, params, opt, lr: float) -> None:
    err = update_err(before, params, opt, lr)
    assert err <= 1.0, f"update off by {err} tolerances"


def clone_tree(tree):
    """A copy of a nested dict of tensors (the state before an in-place
    step)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()
