"""The fused residual add and RMSNorm (``repro_torch.kernels.rms_norm``) on
the CPU: its plain route gives the bits of the float32 chain the models
ran before it, at every served width, and agrees with the JAX package's
``rms_norm``; the route takes the kernel only for the inputs it was built
for (tried on fake CUDA tensors, which need no card); the counters count;
a traced step passes the kernel as one op with its cost; and the
chatglm3-6b smoke prefill is unchanged to the bit. The kernel itself is
held to the chain on the card in ``test_torch_gpu.py``."""

import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.models import mlp as jmlp
from repro_torch.kernels import costs
from repro_torch.kernels import rms_norm as rn
from repro_torch.models import mlp, pspec_ctx

# the served widths (chatglm3-6b and the attention stack 4096, zamba2's
# 3584, 1536 and 6144 of the smaller and larger models) and a narrow one
WIDTHS = [4096, 1536, 3584, 6144, 128]
EPS = 1e-5


def chain(x, scale, eps):
    """The norm as the models computed it before the kernel: eight
    float32 ops."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def _inputs(d, dtype=torch.bfloat16, seed=0, shape=(3, 7)):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, d, generator=gen).to(dtype)
    delta = torch.randn(*shape, d, generator=gen).mul_(0.5).to(dtype)
    scale = torch.rand(d, generator=gen).add_(0.5)
    return x, delta, scale


def _equal_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16 if a.element_size() == 2 else torch.int32),
        b.view(torch.int16 if b.element_size() == 2 else torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_route_gives_the_chains_bits(d, dtype):
    x, delta, scale = _inputs(d, dtype)
    assert rn.fwd_route(x, scale) == rn.fwd_route(x, scale, delta) == "plain"
    assert _equal_bits(mlp.rms_norm(x, scale, EPS), chain(x, scale, EPS))
    h, y = mlp.add_rms_norm(x, delta, scale, EPS)
    assert _equal_bits(h, x + delta)
    assert _equal_bits(y, chain(x + delta, scale, EPS))


@pytest.mark.parametrize("d", WIDTHS)
def test_agrees_with_jax_rms_norm_in_f32(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((4, 9, d)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    want = np.asarray(jmlp.rms_norm(jnp.asarray(x), jnp.asarray(scale), EPS))
    got = mlp.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), EPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _fake_cuda(fake, shape=(4, 8, 64), dtype=torch.bfloat16,
               stride=None, offset=0):
    """A fake CUDA tensor (no card needed): contiguous, or a view with
    ``stride`` and ``offset`` elements into a larger storage."""
    with fake:
        if stride is None and not offset:
            return torch.empty(shape, dtype=dtype, device="cuda")
        base = torch.empty(4096 * 64, dtype=dtype, device="cuda")
        if stride is None:
            stride = [1]
            for size in reversed(shape[1:]):
                stride.insert(0, stride[0] * size)
        return base.as_strided(shape, stride, offset)


def _fake_scale(fake, d=64, dtype=torch.float32):
    with fake:
        return torch.empty(d, dtype=dtype, device="cuda")


def test_route_takes_the_kernel_for_bf16_rows_on_the_card():
    """Contiguous rows, the final norm's strided rows h[:, -1:] (row
    stride S * D), the residual add, and the one-device activation
    context the dry-run traces one card under."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import Mesh
    fake = FakeTensorMode()
    x, scale = _fake_cuda(fake), _fake_scale(fake)
    last = _fake_cuda(fake, (4, 1, 64), stride=(8 * 64, 64, 1),
                      offset=7 * 64)
    with fake:
        assert rn.fwd_route(x, scale) == "fused"
        assert rn.fwd_route(last, scale) == "fused"
        assert rn._row_stride(last) == 8 * 64
        assert rn.fwd_route(x, scale, _fake_cuda(fake)) == "fused"
        with pspec_ctx.activation_ctx(Mesh(("data", "model"), (1, 1))):
            assert pspec_ctx.active() is not None
            assert rn.fwd_route(x, scale) == "fused"


PLAIN_CASES = ["cpu", "f32", "grad", "d_not_multiple_of_8", "too_wide",
               "unaligned_view", "scale_bf16", "scale_shape",
               "rows_without_a_stride", "delta_dtype",
               "sharded_activation_context"]


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_route_keeps_the_chain_for_everything_else(case, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    x, scale, delta = _fake_cuda(fake), _fake_scale(fake), None
    if case == "cpu":
        x, _, scale = _inputs(64)
    elif case == "f32":
        x = _fake_cuda(fake, dtype=torch.float32)
    elif case == "grad":
        x = x.requires_grad_(True)
    elif case == "d_not_multiple_of_8":
        x, scale = _fake_cuda(fake, (4, 8, 60)), _fake_scale(fake, 60)
    elif case == "too_wide":
        x = _fake_cuda(fake, (2, rn.MAX_D + 8))
        scale = _fake_scale(fake, rn.MAX_D + 8)
    elif case == "unaligned_view":
        x = _fake_cuda(fake, offset=4)      # 8 bytes past an aligned base
    elif case == "scale_bf16":
        scale = _fake_scale(fake, dtype=torch.bfloat16)
    elif case == "scale_shape":
        scale = _fake_cuda(fake, (2, 32), dtype=torch.float32)
    elif case == "rows_without_a_stride":     # x.transpose(0, 1)
        x = _fake_cuda(fake, (8, 4, 64), stride=(64, 8 * 64, 1))
    elif case == "delta_dtype":
        delta = _fake_cuda(fake, dtype=torch.float32)
    elif case == "sharded_activation_context":
        ctx = SimpleNamespace(mesh=SimpleNamespace(device_mesh=object()))
        monkeypatch.setattr(pspec_ctx, "active", lambda: ctx)
    with fake:
        assert rn.fwd_route(x, scale, delta) == "plain"
    if case == "grad":
        with torch.no_grad(), fake:
            assert rn.fwd_route(x, scale) == "fused"


_DTENSOR = """
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.launch.dryrun import fake_process_group
    with fake_process_group(1):
        mesh = init_device_mesh("cpu", (1,))
        x = DTensor.from_local(torch.ones(4, 64, dtype=torch.bfloat16),
                               mesh, [Replicate()])
        assert rn._is_dtensor(x) and not rn._is_dtensor(x.to_local())
        assert rn.fwd_route(x, torch.ones(64)) == "plain"
    print("ok")
"""


def test_route_keeps_the_chain_for_a_dtensor():
    """In a subprocess: a process group is process state."""
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_DTENSOR)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_counters_count_each_call_by_route():
    """The plain route counts a route and no launch; on fake CUDA tensors
    the fused route counts its route and passes the op's fake version
    (nothing launched, so nothing counted as a launch)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    x, delta, scale = _inputs(64)
    routes, launches = dict(rn.rms_norm.routes), rn.rms_norm.launches
    mlp.rms_norm(x, scale, EPS)
    mlp.add_rms_norm(x, delta, scale, EPS)
    assert rn.rms_norm.routes["plain"] == routes.get("plain", 0) + 2
    fake = FakeTensorMode()
    xc, sc = _fake_cuda(fake), _fake_scale(fake)
    with fake:
        y = mlp.rms_norm(xc, sc, EPS)
        h, y2 = mlp.add_rms_norm(xc, _fake_cuda(fake), sc, EPS)
    assert y.shape == h.shape == y2.shape == xc.shape
    assert y.is_contiguous() and y.dtype == torch.bfloat16
    assert rn.rms_norm.routes["fused"] == routes.get("fused", 0) + 2
    assert rn.rms_norm.launches == launches


def test_traced_step_counts_the_kernel_ops_with_their_cost():
    """The dry-run's tracer on fake CUDA tensors: each fused norm one
    kernel op, its bytes those of :func:`costs.norm_bound`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.op_analysis import OpAnalysis
    fake = FakeTensorMode()
    shape = (4, 512, 4096)
    x, delta = _fake_cuda(fake, shape), _fake_cuda(fake, shape)
    scale = _fake_scale(fake, 4096)
    mode = OpAnalysis(fake_mode=fake)
    with fake, mode:
        mlp.rms_norm(x, scale, EPS)
        mlp.add_rms_norm(x, delta, scale, EPS)
    assert dict(mode.launches) == {"rms_norm": 1, "add_rms_norm": 1}
    want = (costs.norm_bound((2048, 4096), 2)["bytes"]
            + costs.norm_bound((2048, 4096), 2, delta=True)["bytes"])
    assert mode.by_op["repro_torch.rms_norm"][2] \
        + mode.by_op["repro_torch.add_rms_norm"][2] == want


def test_norm_bound_at_the_prefill_shape():
    """8 bytes an element with the add, 4 without, and the scale once:
    0.080 and 0.040 ms at (8192, 4096) at 3.35 TB/s."""
    with_add = costs.norm_bound((8192, 4096), 2, delta=True)
    plain = costs.norm_bound((8192, 4096), 2)
    assert with_add["bytes"] == 8 * 8192 * 4096 + 4 * 4096
    assert plain["bytes"] == 4 * 8192 * 4096 + 4 * 4096
    assert with_add["bound_by"] == plain["bound_by"] == "bytes"
    assert abs(with_add["bound_ms"] - 0.0801) < 1e-4
    assert abs(plain["bound_ms"] - 0.0401) < 1e-4


def test_chatglm3_smoke_prefill_unchanged_to_the_bit(monkeypatch):
    """The smoke configuration's prefill through the wrappers (every norm
    on the plain route on the CPU, 2 a layer and the final one) gives the
    bits of the same prefill with the norms as the models ran them
    before: the chain, and the residual add in front of ln2 on its
    own."""
    from repro_torch.models import steps, transformer
    from repro_torch.models.config import get_config
    cfg = get_config("chatglm3-6b", smoke=True)
    params = transformer.init_params(cfg, 0, torch.bfloat16, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    prefill = steps.make_prefill_step(cfg)
    routes = dict(rn.rms_norm.routes)
    logits, cache = prefill(params, {"inputs": tokens})
    assert rn.rms_norm.routes["plain"] - routes.get("plain", 0) \
        == 2 * cfg.n_layers + 1
    monkeypatch.setattr(transformer, "rms_norm", chain)
    monkeypatch.setattr(transformer, "add_rms_norm",
                        lambda x, d, s, eps: (x + d, chain(x + d, s, eps)))
    want, want_cache = prefill(params, {"inputs": tokens})
    assert _equal_bits(logits, want)
    assert _equal_bits(cache["k"], want_cache["k"])
    assert _equal_bits(cache["v"], want_cache["v"])
