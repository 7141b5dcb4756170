"""The port's AdamW (``repro_torch.optim``): the JAX package's AdamW cases
(``tests/test_optim.py``) on the port, and parity with the JAX package's
``adamw_update`` on random nested trees over several steps.

The port updates in place: ``adamw_update`` returns the dicts it was given,
with the parameters, moments and step written. Gradient compression is not
ported (ROADMAP.md A12d), so the int8 cases stay with the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jopt
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, warmup_cosine)


def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=5,
                      total_steps=200)
    target = torch.tensor([3.0, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(150):
        w = params["w"].clone().requires_grad_(True)
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, opt, _ = adamw_update(g, opt, params, cfg)
    assert float(loss(params)) < 1e-2


def test_weight_decay_shrinks_params():
    cfg = AdamWConfig(lr=0.01, weight_decay=0.5, warmup_steps=0,
                      total_steps=100)
    params = {"w": torch.ones(4) * 10.0}
    opt = adamw_init(params)
    for _ in range(20):
        params, opt, _ = adamw_update({"w": torch.zeros(4)}, opt, params,
                                      cfg)
    assert float(params["w"].abs().max()) < 10.0


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 10.0, "b": torch.ones(2) * 10.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in clipped.values()))
    assert abs(float(total) - 1.0) < 1e-5
    assert float(norm) > 1.0
    assert clipped is g                        # scaled in place
    _, small = clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert abs(float(small) - 0.2) < 1e-7      # under the limit: unscaled


def test_warmup_cosine_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(warmup_cosine(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 0.01
    assert lrs[100] <= 0.11
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))  # decay
    jcfg = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    want = [float(jopt.warmup_cosine(jcfg, jnp.asarray(s)))
            for s in range(101)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=1e-7)


def test_state_layout_and_in_place_update():
    params = {"b": {"x": torch.ones(2, 3)}, "a": torch.ones(5)}
    opt = adamw_init(params)
    assert set(opt) == {"m", "v", "step"}
    assert opt["step"].dtype == torch.int32 and opt["step"].dim() == 0
    assert opt["m"]["b"]["x"].dtype == torch.float32
    ids = [id(params["a"]), id(opt["m"]["a"]), id(opt["v"]["b"]["x"])]
    grads = {"b": {"x": torch.full((2, 3), 0.5)}, "a": torch.ones(5)}
    p2, o2, metrics = adamw_update(grads, opt, params, AdamWConfig())
    assert p2 is params and o2 is opt
    assert ids == [id(p2["a"]), id(o2["m"]["a"]), id(o2["v"]["b"]["x"])]
    assert int(opt["step"]) == 1 and set(metrics) == {"grad_norm", "lr"}


def random_tree(rng, scale):
    return {"embed": rng.standard_normal((7, 5)).astype(np.float32) * scale,
            "blocks": {"wq": rng.standard_normal((3, 5, 4)).astype(
                np.float32) * scale,
                "norm": rng.standard_normal((3, 5)).astype(np.float32)},
            "bias": rng.standard_normal(6).astype(np.float32) * scale}


@pytest.mark.parametrize("seed,clip", [(0, 1.0), (1, 1.0), (2, 100.0),
                                       (3, 0.1)])
def test_adamw_update_matches_jax_on_random_trees(seed, clip):
    """Five steps on the same random parameters and gradients (clipping
    active or not): the port's in-place update against JAX's returned
    trees, within 1e-6 (f32 rounding of the same formula)."""
    rng = np.random.default_rng(seed)
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip, warmup_steps=2,
               total_steps=10)
    p_np = random_tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, p_np)
    jo = jopt.adamw_init(jp)
    tp = jax.tree.map(torch.from_numpy, p_np)
    to = adamw_init(tp)
    for _ in range(5):
        g_np = random_tree(rng, 3.0)
        jp, jo, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g_np), jo,
                                       jp, jopt.AdamWConfig(**cfg))
        _, _, tm = adamw_update(jax.tree.map(torch.from_numpy, g_np), to,
                                tp, AdamWConfig(**cfg))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(to["step"]) == int(jo["step"]) == 5
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                        jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
