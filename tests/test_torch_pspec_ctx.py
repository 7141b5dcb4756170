"""The port's activation-sharding context (``repro_torch.models.pspec_ctx``)
held to the JAX package's (``repro.models.pspec_ctx``): ``constrain`` is
the identity outside a context and for plain tensors, its guards pin the
spec JAX's pins, and the MoE layer's dispatch groups follow JAX's rule. The
MoE smoke configuration with G = 2 dispatch groups matches JAX, which runs
it in a subprocess on 2 forced host devices under its context, at
``tests/test_torch_moe.py``'s tolerances and top-k margin."""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.models import pspec_ctx as jctx
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import pspec_ctx as ctx
from repro_torch.models.config import get_config
from repro_torch.models.convert import params_from_numpy

from test_torch_moe import TOL, routing_margin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = [Mesh(("data", "model"), (16, 16)),
          Mesh(("pod", "data", "model"), (2, 16, 16)),
          Mesh(("data", "model"), (32, 8)),
          Mesh(("pod", "data", "model"), (2, 32, 8)),
          Mesh(("data", "model"), (1, 1)),
          Mesh(("data",), (4,))]


def test_constrain_is_the_identity_outside_a_context():
    x = torch.randn(4, 8, 16)
    assert ctx.active() is None
    assert ctx.constrain(x, "dp", "tp", None) is x
    assert ctx.constrain_to(x, ("data", None, None)) is x
    tree = {"w": x}
    assert ctx.gather_for_compute(tree) is tree
    fn = lambda a: a  # noqa: E731
    assert ctx.local(fn, [("dp",)], ("dp",)) is fn


def test_constrain_is_the_identity_for_plain_tensors_in_a_context():
    x = torch.randn(32, 8, 16)
    with ctx.activation_ctx(MESHES[2]):
        assert ctx.active() is not None
        assert ctx.constrain(x, "dp", "tp", None) is x
        assert ctx.gather_for_compute({"w": x})["w"] is x
    assert ctx.active() is None


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m.sizes)))
def test_guards_and_axes_equal_jax(mesh, monkeypatch):
    """The spec the port pins equals the PartitionSpec JAX's constrain
    hands to ``with_sharding_constraint`` (captured), for shapes that do
    and do not divide the axes."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: tuple(spec))
    stub = SimpleNamespace(shape=mesh.shape, axis_names=mesh.axis_names)
    cases = [((256, 4096, 48, 128), ("dp", None, "tp", None)),
             ((1, 4096, 12, 128), ("dp", None, "tp", None)),
             ((96, 4096, 6144), ("dp", "tp", None)),
             ((64, 100, 7), ("dp", "tp")),
             ((32, 512, 151936), ("dp", None, "tp")),
             ((16, 8, 4, 8), (None, "tp", None, None))]
    with ctx.activation_ctx(mesh), jctx.activation_ctx(stub):
        c, jc = ctx.active(), jctx.active()
        assert (c.dp, c.tp, c.dp_size, c.tp_size) == (
            jc.dp, jc.tp, jc.dp_size, jc.tp_size)
        for shape, tokens in cases:
            jspec = jctx.constrain(SimpleNamespace(shape=shape), *tokens)
            assert ctx.guarded_spec(c, shape, tokens) == jspec


def test_param_specs_by_path_string():
    from repro_torch.models import sharding as shd
    cfg = get_config("minitron-4b")
    specs = shd.param_specs(cfg, MESHES[2])
    with ctx.activation_ctx(MESHES[2], specs):
        c = ctx.active()
        assert c.param_spec("blocks/attn/wq") == specs["blocks"]["attn"]["wq"]
        assert c.param_spec("embed") == specs["embed"]
        assert c.param_spec("nowhere") is None
    assert ctx.path_str(("blocks", "mlp", "wg")) == "blocks/mlp/wg"


@pytest.mark.parametrize("sizes,T,block,expect", [
    ((2, 1), 32, True, 2), ((4, 2), 32, True, 4), ((4, 2), 30, True, 1),
    ((1, 8), 32, True, 1), ((2, 1), 32, False, 1)])
def test_dispatch_groups_follow_jax(sizes, T, block, expect):
    from repro.models import moe as jmoe
    from repro.models.config import get_config as jget
    mesh = Mesh(("data", "model"), sizes)
    stub = SimpleNamespace(shape=mesh.shape, axis_names=mesh.axis_names)
    cfg = get_config("dbrx-132b", smoke=True, moe_block_dispatch=block)
    jcfg = jget("dbrx-132b", smoke=True, moe_block_dispatch=block)
    assert tmoe._dispatch_groups(cfg, T) == 1 == jmoe._dispatch_groups(
        jcfg, T)
    with ctx.activation_ctx(mesh), jctx.activation_ctx(stub):
        assert tmoe._dispatch_groups(cfg, T) == expect
        assert jmoe._dispatch_groups(jcfg, T) == expect


_JAX_G2 = """
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.launch.mesh import make_mesh_for
    from repro.models import moe as jmoe
    from repro.models.config import get_config
    from repro.models.pspec_ctx import activation_ctx
    assert len(jax.devices()) == 2
    cfg = get_config("dbrx-132b", smoke=True, capacity_factor=0.5)
    p = jmoe.init_moe(jax.random.PRNGKey(3), cfg, 0, jnp.float32)
    x = np.random.default_rng(5).standard_normal(
        (4, 24, cfg.d_model)).astype(np.float32)
    mesh = make_mesh_for(2, 1)
    with mesh, activation_ctx(mesh), jax.default_matmul_precision("highest"):
        G = jmoe._dispatch_groups(cfg, 4 * 24)
        out, aux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg))(p, x)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model)
                           @ p["router"], axis=-1)
    np.savez(sys.argv[1], out=np.asarray(out), aux=np.asarray(aux), x=x,
             probs=np.asarray(probs),
             **{k: np.asarray(v) for k, v in p.items()})
    print(json.dumps({"G": G}))
"""


def test_moe_with_two_dispatch_groups_matches_jax(tmp_path):
    path = str(tmp_path / "jax_g2.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_G2),
                           path], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["G"] == 2
    z = np.load(path)
    # capacity factor 0.5: 16 slots an expert in each group of 48 tokens
    # (24 in one group of 96), so capacity drops happen and differ by G
    cfg = get_config("dbrx-132b", smoke=True, capacity_factor=0.5)
    tp = params_from_numpy({k: z[k] for k in ("router", "wg", "wu", "wd")},
                           "cpu")
    tx = torch.from_numpy(z["x"])
    tprobs = torch.softmax(tx.reshape(-1, cfg.d_model) @ tp["router"],
                           -1).numpy()
    err = float(np.max(np.abs(tprobs - z["probs"])))
    assert routing_margin(z["probs"], cfg.experts_per_token) > 10 * err
    mesh = Mesh(("data", "model"), (2, 1))
    with ctx.activation_ctx(mesh):
        assert tmoe._dispatch_groups(cfg, tx.shape[0] * tx.shape[1]) == 2
        out, aux = tmoe.moe_apply(tp, tx, cfg)
    np.testing.assert_allclose(out.numpy(), z["out"], **TOL)
    np.testing.assert_allclose(float(aux), float(z["aux"]), **TOL)
    # per-group capacity: the one-group result differs (drops move)
    assert (tmoe.capacity(48, cfg), tmoe.capacity(96, cfg)) == (16, 24)
    one, _ = tmoe.moe_apply(tp, tx, cfg)
    assert not torch.allclose(one, out, **TOL)
