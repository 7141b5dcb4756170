"""Tests of the port that need an NVIDIA GPU: each CUDA kernel against its
plain version (the backward kernels of flash attention, SSD and WKV too),
the gradients through each forward and backward kernel pair, smoke train
steps of qwen2-vl, zamba2, rwkv6 and the MoE family on the card against
the CPU, and the AnEn workflow (on the DAG tier), the multi-tenant
service's AnEn sweeps, the seismic misfit sweeps (chain and DAG tiers),
the zamba2, rwkv6, dense and MoE serving paths and the qwen2-vl prefill on
embeddings on the card against the same runs on the CPU; int8 gradient
compression (the CPU's bits, a smoke ``TrainSession``) and the one-device
dry-run against a real step's peak memory, launches and matmul FLOPs; the
sharded tier over lanes of the card (B2 against B1, AnEn and the seismic
DAG against their unsharded runs; its link graphs: a replay bit-equal to
eager, a second sweep replayed without a capture, a host sync refused and
run eagerly), and over two cards where there are; the compressed mean
over an NCCL group of one process; flash attention's non-causal kernels
(forward and backward, both routes) against their plain versions; the
bf16 forward's wgmma kernel at every padded head dim, S around its tiles
and both modes (equal bits on a second call), the inputs that take the
mma.sync kernel instead, and each forward's compiled threads and spills;
the bf16 backward's wgmma kernels likewise at the train paths' head dims,
its route by shape and its compiled kernels; the WKV backward's wgmma
route (with and without a final-state gradient, at the clamps), the
inputs that keep its mma.sync route, and its compiled kernel; a
checkpoint restored onto an NCCL mesh of one rank with shardings; the
fused residual add and RMSNorm against the plain chain (each served
width, strided rows, no spill), chatglm3-6b's smoke prefill on its fused
route and train steps that launch no norm.
They skip where ``torch.cuda.is_available()`` is False. This file
imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

# the main path's shapes, N % 4 != 0 (scalar loads, ragged quad) and
# fewer than 4 columns
SHAPES = [(60, 3, 37), (9, 2, 130), (64, 3, 256), (365, 3, 512),
          (365, 3, 1024), (365, 3, 4096), (365, 3, 510), (7, 3, 3),
          (5, 1, 1), (3, 16, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_bit_equal_to_plain(cuda, shape):
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_plain)
    h, v, n = shape
    rng = np.random.default_rng(7)
    fh = torch.from_numpy(rng.standard_normal((h, v, n)).astype(np.float32))
    fn = torch.from_numpy(rng.standard_normal((v, n)).astype(np.float32))
    fh, fn = fh.to(cuda), fn.to(cuda)
    before = anen_distance.launches
    got = anen_distance(fh, fn)
    torch.cuda.synchronize()
    assert anen_distance.launches == before + 1
    assert torch.equal(got, anen_distance_plain(fh, fn))


def test_cuda_kernel_bit_equal_to_plain_unaligned(cuda):
    """Inputs 4 bytes past a 16-byte boundary take the scalar loads even
    where N % 4 == 0."""
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_plain)
    h, v, n = 33, 3, 64
    rng = np.random.default_rng(8)
    flat = torch.from_numpy(rng.standard_normal(h * v * n + 1)
                            .astype(np.float32)).to(cuda)
    fh = flat[1:].view(h, v, n)
    fn = torch.from_numpy(rng.standard_normal((v, n)).astype(np.float32)
                          ).to(cuda)
    assert fh.data_ptr() % 16 != 0
    got = anen_distance(fh, fn)
    torch.cuda.synchronize()
    assert torch.equal(got, anen_distance_plain(fh, fn))


def test_workflow_on_card_matches_cpu(cuda):
    """An AnEn round on the card is one DAG carrier that launches the
    distance kernel once, and its errors equal the CPU run's."""
    from repro_torch.apps.anen.workflow import run_adaptive
    from repro_torch.kernels.anen_distance import anen_distance
    kw = dict(seed=3, ny=20, nx=20, n_hist=30, per_iter=16, max_iters=2,
              n_tasks=4, slots=4, timeout=120)
    before = anen_distance.launches
    on_gpu = run_adaptive(device="cuda", **kw)
    launches = anen_distance.launches - before
    on_cpu = run_adaptive(device="cpu", **kw)
    assert on_gpu["all_done"] and on_cpu["all_done"]
    stats = on_gpu["fusion_stats"]
    assert stats["dag_carriers"] == kw["max_iters"]
    assert launches == kw["max_iters"]
    assert stats["scalar_fallback"] == 0 and stats["degraded"] == 0
    assert {k: v for k, v in stats.items() if k.startswith("dag")} == \
        {k: v for k, v in on_cpu["fusion_stats"].items()
         if k.startswith("dag")}
    assert np.allclose(on_gpu["errors"], on_cpu["errors"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("run", ["run_misfit_chain", "run_misfit_ensemble"])
def test_seismic_sweep_on_card_matches_cpu(cuda, run):
    from repro_torch.apps.seismic import workflow as wf
    kw = dict(nx=32, nt=60, seed=0, dv=25.0)
    on_gpu = getattr(wf, run)(8, device="cuda", **kw)
    on_cpu = getattr(wf, run)(8, device="cpu", **kw)
    assert on_gpu["all_done"] and on_cpu["all_done"]
    assert on_gpu["fusion_stats"]["dag_carriers"] == 1
    assert on_gpu["fusion_stats"]["degraded"] == 0
    assert np.allclose(on_gpu["misfits"], on_cpu["misfits"], rtol=1e-4,
                       atol=0)
    assert np.isclose(on_gpu["total_misfit"], on_cpu["total_misfit"],
                      rtol=1e-4, atol=0)


def test_seismic_chain_alone_on_card_matches_cpu(cuda):
    from repro_torch import api
    from repro_torch.apps.seismic.workflow import build_misfit_chain
    from repro_torch.rts.base import ResourceDescription
    from repro_torch.rts.torch_rts import TorchRTS
    out = {}
    for dev in ("cuda", "cpu"):
        box = []

        def factory(dev=dev):
            box.append(TorchRTS(device=dev, slot_oversubscribe=4))
            return box[-1]

        ens = build_misfit_chain(8, nx=32, nz=32, nt=60, dv=25.0, device=dev)
        res = api.run(ens, resources=ResourceDescription(slots=4),
                      rts_factory=factory, timeout=120)
        assert res.all_done
        out[dev] = ([float(np.asarray(s.out.result())) for s in ens.specs],
                    box[0].fusion_stats)
        res.close()
    stats = out["cuda"][1]
    assert stats["chain_carriers"] >= 1
    assert stats["chain_links"] == 2 * stats["chain_carriers"]
    assert stats["degraded"] == 0 and stats["scalar_fallback"] == 0
    assert np.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=0)


def _scan_inputs(name, shape, dtype, cuda, seed=0):
    """The scan's inputs, its output gradient (in the input dtype) and a
    final-state gradient."""
    if name == "mamba2_ssd":
        args = _ssd_inputs(shape, dtype, cuda, seed)
    else:
        args = _wkv_inputs(shape, dtype, cuda, seed)
    rng = np.random.default_rng(seed + 100)
    dout = torch.from_numpy(rng.standard_normal(tuple(args[0].shape))
                            .astype(np.float32)).to(cuda).to(dtype)
    dstate = torch.from_numpy(rng.standard_normal(tuple(args[5].shape))
                              .astype(np.float32)).to(cuda)
    return args, dout, dstate


def _scan_fns(name):
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    return (getattr(mod, name), getattr(mod, f"{name}_plain"),
            getattr(mod, f"{name}_bwd"), getattr(mod, f"{name}_bwd_plain"))


@pytest.mark.parametrize("name,shape", [("mamba2_ssd", (1, 64, 2, 16, 1, 8)),
                                        ("mamba2_ssd", (2, 100, 4, 16, 2, 8)),
                                        ("rwkv6_wkv", (1, 64, 2, 16)),
                                        ("rwkv6_wkv", (2, 100, 3, 8))])
def test_cuda_scan_route_takes_grads(cuda, name, shape):
    """The SSD and WKV CUDA routes take grads: under grad the call records
    the autograd.Function, launches the forward kernel once, and
    ``autograd.grad`` launches the backward kernel once; the gradients of
    every input (the final state's too) match autograd through the plain
    forward at the JAX gradient tolerance, in f32."""
    fn, plain, bwd, _ = _scan_fns(name)
    args, dout, dstate = _scan_inputs(name, shape, torch.float32, cuda)
    args = [a.requires_grad_(True) for a in args]
    before = (fn.launches, bwd.launches)
    out, state = fn(*args)
    got = torch.autograd.grad((out, state), args, (dout, dstate))
    torch.cuda.synchronize()
    assert (fn.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_out, ref_state = plain(*args)
    want = torch.autograd.grad((ref_out, ref_state), args, (dout, dstate))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)


# the backward's tolerances: f32 the JAX gradient tolerance
# (tests/test_kernels.py); bf16 one rounding of each f32 sum to bf16
# (2^-8 of |ref|) with room
BWD_TOLERANCES = {torch.float32: 5e-4, torch.bfloat16: 1e-2}
FLASH_BWD_SHAPES = [(4, 512, 32, 112), (4, 512, 12, 128), (4, 100, 32, 160),
                    (2, 65, 3, 160), (4, 100, 32, 150), (2, 65, 3, 150)]
FLASH_BWD_SHAPES += [(2, S, 3, 32) for S in (1, 63, 64, 65, 100, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES)
def test_flash_attention_backward_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    q, k, v = _attention_inputs(shape, dtype, cuda)
    dout = _attention_inputs(shape, dtype, cuda, seed=1)[0]
    out, lse = flash_attention(q, k, v)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout)
    tol = BWD_TOLERANCES[dtype]
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == q.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(4, 512, 12, 128), (4, 100, 32, 150),
                                   (2, 65, 3, 160)])
def test_flash_attention_backward_bf16_gives_equal_bits(cuda, shape):
    """The bf16 route (tensor cores) has no atomics: two calls on the same
    inputs give the same bits."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    q, k, v = _attention_inputs(shape, torch.bfloat16, cuda)
    dout = _attention_inputs(shape, torch.bfloat16, cuda, seed=1)[0]
    out, lse = flash_attention(q, k, v)
    first = flash_attention_bwd(q, k, v, out, lse, dout)
    second = flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(4, 512, 12, 128), (2, 65, 3, 150)])
def test_flash_attention_backward_f32_route_unchanged(cuda, shape):
    """The f32 route keeps the first port's CUDA-core kernels: within 1e-5
    of the plain version, as they were."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    q, k, v = _attention_inputs(shape, torch.float32, cuda)
    dout = _attention_inputs(shape, torch.float32, cuda, seed=1)[0]
    out, lse = flash_attention(q, k, v)
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64, 112, 128])
@pytest.mark.parametrize("which", ["dkdv", "dq"])
def test_flash_attention_backward_bf16_kernels_fit_at_hd_128(cuda, which, hd,
                                                             causal):
    """At the train paths' head dims (128, 112, 32) and 64, in both
    modes, the bf16 kernels are the wgmma ones (a producer warp and two
    consumer warpgroups, one block an SM) and spill nothing."""
    from repro_torch.kernels.flash_attention import bwd_kernel_info
    info = bwd_kernel_info(hd, torch.bfloat16, which, causal)
    assert info["route"] == "wgmma" and info["threads"] == 384
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] == 1


# the bf16 backward's wgmma kernels: the train shapes, then S at and around
# the 64- and 128-row tiles' edges at each head dim the train paths take
# (and 64)
WGMMA_BWD_SHAPES = [(4, 512, 12, 128), (4, 512, 32, 112), (8, 128, 4, 32)]
WGMMA_BWD_SHAPES += [(2, S, 3, hd) for hd in (32, 64, 112, 128)
                     for S in (1, 63, 65, 100, 300)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", WGMMA_BWD_SHAPES)
def test_flash_attention_backward_wgmma_matches_plain(cuda, shape, causal):
    """The wgmma backward (TMA ring, producer warp, two consumer
    warpgroups) against the plain version in both modes, one launch a
    call; a second call gives equal bits."""
    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain)
    q, k, v = _attention_inputs(shape, torch.bfloat16, cuda)
    dout = _attention_inputs(shape, torch.bfloat16, cuda, seed=1)[0]
    out, lse = flash_attention(q, k, v, causal=causal)
    assert bwd_route(q, k, v, out, dout) == "wgmma"
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
    tol = BWD_TOLERANCES[torch.bfloat16]
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("what", ["unaligned", "hd 150", "hd 160"])
def test_flash_attention_backward_mma_sync_route_by_shape(cuda, what, causal):
    """The backward's route by shape: bf16 views 2 bytes past a 16-byte
    boundary, hd 150 (hd % 8 != 0) and hd 160 (above the wgmma kernels'
    128) take the mma.sync kernels and meet the plain version with equal
    bits on a second call; the same values aligned at hd 112 take wgmma,
    f32 the CUDA cores."""
    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain)
    shape = {"unaligned": (2, 100, 3, 112), "hd 150": (2, 100, 3, 150),
             "hd 160": (2, 65, 3, 160)}[what]
    q, k, v = _attention_inputs(shape, torch.bfloat16, cuda)
    dout = _attention_inputs(shape, torch.bfloat16, cuda, seed=1)[0]
    out, lse = flash_attention(q, k, v, causal=causal)
    if what == "unaligned":
        assert bwd_route(q, k, v, out, dout) == "wgmma"
        views = []
        for a in (q, k, v, out, dout):
            flat = torch.empty(a.numel() + 8, dtype=a.dtype, device=cuda)
            view = flat[1:1 + a.numel()].view(shape)
            view.copy_(a)
            views.append(view)
        q, k, v, out, dout = views
        assert q.data_ptr() % 16 != 0
    assert bwd_route(q, k, v, out, dout) == "mma.sync"
    assert bwd_route(*(a.float() for a in (q, k, v, out, dout))) == \
        "cuda-cores"
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
    tol = BWD_TOLERANCES[torch.bfloat16]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape", [(2, 100, 3, 64), (1, 65, 2, 160)])
def test_flash_attention_cuda_route_takes_grads(cuda, shape):
    """``autograd.grad`` through the forward and backward kernels (one
    launch each) against autograd through the plain forward."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_plain)
    q, k, v = (a.requires_grad_(True)
               for a in _attention_inputs(shape, torch.float32, cuda))
    dout = _attention_inputs(shape, torch.float32, cuda, seed=1)[0]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out, lse = flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert not lse.requires_grad
    ref, _ = flash_attention_plain(q, k, v)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)


# the backward kernels' shapes: the train shape, a ragged T (chunk 50), G
# = 2 (also at T = 100), N != P and N = 5 (SSD), chunk 1, N = 5 and 32
# (WKV); the bf16 routes pad N and P to 16, 32, 64 or 128
SSD_BWD_SHAPES = [(4, 512, 112, 64, 1, 64), (4, 100, 112, 64, 1, 64),
                  (2, 128, 8, 64, 2, 64), (1, 100, 3, 16, 1, 8),
                  (2, 128, 4, 32, 2, 16), (2, 64, 2, 128, 1, 128),
                  (2, 100, 8, 64, 2, 64), (1, 100, 3, 16, 1, 5)]
WKV_BWD_SHAPES = [(4, 512, 40, 64), (4, 100, 40, 64), (1, 97, 2, 64),
                  (2, 100, 3, 16), (1, 100, 2, 5), (2, 100, 4, 32)]
SCAN_BWD_CASES = ([("mamba2_ssd", s) for s in SSD_BWD_SHAPES]
                  + [("rwkv6_wkv", s) for s in WKV_BWD_SHAPES])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape", SCAN_BWD_CASES)
def test_scan_backward_kernel_matches_plain(cuda, name, shape, dtype):
    """The SSD and WKV backward kernels against their plain versions, with
    a nonzero state0 and final-state gradient, at ``BWD_TOLERANCES``: both
    sum in f32 and round each gradient once to its input's dtype."""
    _, _, bwd, bwd_plain = _scan_fns(name)
    args, dout, dstate = _scan_inputs(name, shape, dtype, cuda)
    before = bwd.launches
    got = bwd(*args, dout, dstate)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    want = bwd_plain(*args, dout, dstate)
    tol = BWD_TOLERANCES[dtype]
    for a, b, x in zip(got, want, args):
        assert a.dtype == x.dtype and a.shape == x.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_backward_kernel_matches_plain_at_the_clamps(cuda, dtype):
    """A quarter of the channels decay by e^-0.5..e^-3 a step, so their
    cumsum passes -30 inside a chunk, and channel 32 has w = 1e-9 at the
    10th step of each chunk: no gradient passes either clamp, on both
    sides. (The two clamps in one channel multiply by 1/1e-8 where terms
    near 1e8 cancel in f32: ``chip_smoke.scan_bwd_inputs``.)"""
    _, _, bwd, bwd_plain = _scan_fns("rwkv6_wkv")
    args, dout, dstate = _scan_inputs("rwkv6_wkv", (2, 128, 3, 64), dtype,
                                      cuda)
    rng = np.random.default_rng(5)
    w = args[3]
    w[..., :16] = torch.from_numpy(np.exp(-rng.uniform(
        0.5, 3.0, (2, 128, 3, 16))).astype(np.float32)).to(cuda).to(dtype)
    w[:, 9::64, :, 32] = 1e-9
    got = bwd(*args, dout, dstate)
    want = bwd_plain(*args, dout, dstate)
    tol = BWD_TOLERANCES[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
    assert torch.equal(got[3][:, 9::64, :, 32],
                       torch.zeros_like(got[3][:, 9::64, :, 32]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape", [("mamba2_ssd", (4, 512, 112, 64, 1,
                                                        64)),
                                        ("mamba2_ssd", (2, 100, 4, 32, 2,
                                                        16)),
                                        ("mamba2_ssd", (2, 100, 8, 64, 2,
                                                        64)),
                                        ("rwkv6_wkv", (4, 512, 40, 64)),
                                        ("rwkv6_wkv", (2, 100, 3, 16))])
def test_scan_backward_gives_equal_bits(cuda, name, shape, dtype):
    """No atomics: the sums over blocks (dA, du, the group's dB and dC;
    on the bf16 routes also over chunks) run in a fixed order, so two
    calls give the same bits."""
    _, _, bwd, _ = _scan_fns(name)
    args, dout, dstate = _scan_inputs(name, shape, dtype, cuda)
    first = bwd(*args, dout, dstate)
    second = bwd(*args, dout, dstate)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_backward_kernels_spill_nothing_at_the_train_shapes(cuda,
                                                                dtype):
    """f32: the CUDA-core scan, 512 threads; bf16: SSD's cluster kernel
    (the train shape's route: one warpgroup, 2 blocks an SM, a cluster of
    the 8 chunks fits the card) and both kernels of the mma.sync route
    (the walk and the chunk kernel 4 warps each, the chunk kernel 2 blocks
    an SM), WKV's (the walk 8 warps, the chunk kernel 16)."""
    from repro_torch.kernels import mamba2_ssd, rwkv6_wkv
    bf16 = dtype == torch.bfloat16
    for part in ("chunk", "walk") if bf16 else ("chunk",):
        ssd = mamba2_ssd.bwd_kernel_info(64, 64, 64, dtype, part)
        wkv = rwkv6_wkv.bwd_kernel_info(64, 64, dtype, part)
        for info, threads in ((ssd, 128), (wkv, 512 if part == "chunk"
                                           else 256)):
            assert info["spill_bytes"] == 0, (part, info)
            assert info["blocks_per_sm"] >= 1, (part, info)
            assert info["threads"] == (threads if bf16 else 512), (part, info)
    if bf16:
        chunk = mamba2_ssd.bwd_kernel_info(64, 64, 64, dtype, "chunk")
        assert chunk["blocks_per_sm"] >= 2, chunk
        cluster = mamba2_ssd.bwd_kernel_info(64, 64, 64, dtype, "cluster")
        assert cluster["spill_bytes"] == 0, cluster
        assert cluster["threads"] == 128, cluster
        assert cluster["blocks_per_sm"] >= 2, cluster
        assert mamba2_ssd.bwd_max_clusters(8) >= 1


# the cluster route's shapes (zamba2's train shape, fewer chunks and
# heads), beside shapes of the same widths that keep the mma.sync route
SSD_CLUSTER_CASES = [((4, 512, 112, 64, 1, 64), "cluster"),
                     ((4, 100, 112, 64, 1, 64), "mma.sync"),   # chunk 50
                     ((2, 192, 6, 64, 1, 64), "cluster"),      # 3 chunks
                     ((1, 64, 3, 64, 1, 64), "cluster"),       # 1 chunk
                     ((1, 1024, 2, 64, 1, 64), "mma.sync")]    # 16 chunks


@pytest.mark.parametrize("with_ds", [True, False])
@pytest.mark.parametrize("shape,route", SSD_CLUSTER_CASES)
def test_ssd_backward_route_matches_plain(cuda, shape, route, with_ds):
    """The bf16 SSD backward on its route against the plain version, with
    and without a final-state gradient, at the 1e-2 gate; a second call
    gives equal bits (the chunk states pass from block to block in chunk
    order and the head groups' dB and dC are summed in a fixed order)."""
    from repro_torch.kernels import mamba2_ssd
    args, dout, dstate = _scan_inputs("mamba2_ssd", shape, torch.bfloat16,
                                      cuda)
    ds = dstate if with_ds else None
    assert mamba2_ssd.bwd_route(args[0], args[3], args[4], dout) == route
    before = mamba2_ssd.mamba2_ssd_bwd.routes[route]
    got = mamba2_ssd.mamba2_ssd_bwd(*args, dout, ds)
    torch.cuda.synchronize()
    assert mamba2_ssd.mamba2_ssd_bwd.routes[route] == before + 1
    want = mamba2_ssd.mamba2_ssd_bwd_plain(*args, dout, ds)
    tol = BWD_TOLERANCES[torch.bfloat16]
    for a, b, x in zip(got, want, args):
        assert a.dtype == x.dtype and a.shape == x.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
    again = mamba2_ssd.mamba2_ssd_bwd(*args, dout, ds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("H", [17, 6, 20, 32])
def test_ssd_backward_cluster_head_groups(cuda, H):
    """Blocks of 1, 6, 10 and 16 heads (``cluster_heads(H)``, the largest
    divisor of H up to 16) give the gradient within the gate, equal bits
    on a second call."""
    from repro_torch.kernels import mamba2_ssd
    shape = (1, 512, H, 64, 1, 64)
    args, dout, dstate = _scan_inputs("mamba2_ssd", shape, torch.bfloat16,
                                      cuda, seed=3)
    assert mamba2_ssd.bwd_route(args[0], args[3], args[4], dout) == "cluster"
    got = mamba2_ssd.mamba2_ssd_bwd(*args, dout, dstate)
    assert all(torch.equal(a, b) for a, b in zip(
        got, mamba2_ssd.mamba2_ssd_bwd(*args, dout, dstate)))
    want = mamba2_ssd.mamba2_ssd_bwd_plain(*args, dout, dstate)
    tol = BWD_TOLERANCES[torch.bfloat16]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


def test_ssd_backward_unaligned_view_takes_mma_sync(cuda):
    """x that a TMA map cannot describe (its data 2 bytes past a 16-byte
    boundary) keeps the mma.sync route, within the gate."""
    from repro_torch.kernels import mamba2_ssd
    shape = (1, 128, 2, 64, 1, 64)
    args, dout, dstate = _scan_inputs("mamba2_ssd", shape, torch.bfloat16,
                                      cuda)
    flat = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    x = flat[1:].view(args[0].shape).copy_(args[0])
    args = [x, *args[1:]]
    assert mamba2_ssd.bwd_route(x, args[3], args[4], dout) == "mma.sync"
    got = mamba2_ssd.mamba2_ssd_bwd(*args, dout, dstate)
    want = mamba2_ssd.mamba2_ssd_bwd_plain(*args, dout, dstate)
    tol = BWD_TOLERANCES[torch.bfloat16]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_bwd_route_names_every_shape(cuda, shape):
    """``bwd_route`` names the route of every backward shape: the cluster
    kernel at N = P = chunk = 64 with one B/C group and at most 8 chunks,
    mma.sync for the other bf16 shapes, the CUDA cores for f32."""
    from repro_torch.kernels import mamba2_ssd
    from repro_torch.kernels.costs import pick_chunk
    B, T, H, P, G, N = shape
    for dtype in (torch.float32, torch.bfloat16):
        args, dout, _ = _scan_inputs("mamba2_ssd", shape, dtype, cuda)
        route = mamba2_ssd.bwd_route(args[0], args[3], args[4], dout)
        if dtype == torch.float32:
            assert route == "cuda-cores"
        else:
            cluster = (pick_chunk(T) == 64 and N == P == 64 and G == 1
                       and T // 64 <= 8)
            assert route == ("cluster" if cluster else "mma.sync"), route


def _attention_inputs(shape, dtype, cuda, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(cuda).to(dtype) for _ in range(3)]


def _ssd_inputs(shape, dtype, cuda, seed=0):
    B, T, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, Bm, Cm = f(B, T, H, P), f(B, T, G, N) * 0.5, f(B, T, G, N) * 0.5
    dt = np.log1p(np.exp(f(B, T, H)))
    A = -np.exp(f(H) * 0.5)
    s0 = f(B, H, N, P) * 0.1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    return [t(x).to(dtype), t(dt), t(A), t(Bm).to(dtype), t(Cm).to(dtype),
            t(s0)]


TOLERANCES = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 6e-2)}


# the serve shape and ragged ones, then the shapes the tensor-core tiles
# make awkward: every head dim in {32, 64, 112, 128} at S at and around the
# 64-row tile edges, for one (b, h) and for 128 of them
FLASH_SHAPES = [(4, 512, 32, 112), (1, 100, 2, 112), (2, 300, 3, 64),
                (1, 128, 1, 32)]
FLASH_SHAPES += [(B, S, H, hd) for hd in (32, 64, 112, 128)
                 for S in (1, 63, 65, 100, 512) for B, H in ((1, 1), (4, 32))
                 if (B, S, H, hd) not in FLASH_SHAPES]
# head dims above 128 (1 x 8 warps a block on the tensor cores): 144, 150
# (not a multiple of 8: element-wise tile fills) and stablelm-12b's 160
FLASH_SHAPES += [(B, S, H, hd) for hd in (144, 150, 160)
                 for S in (1, 63, 65, 100, 512) for B, H in ((1, 1), (4, 32))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = _attention_inputs(shape, dtype, cuda)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_out, ref_lse = flash_attention_plain(q, k, v)
    tol = TOLERANCES[dtype][0]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)


# causal=False (bidirectional attention): the attention stack's head dims
# at S = 512, a ragged S, the 64-row tile's edges and S = 1
FLASH_FULL_SHAPES = [(4, 512, 32, 112), (4, 512, 24, 128), (4, 512, 32, 160),
                     (4, 300, 32, 112), (2, 1, 3, 32), (2, 63, 3, 64),
                     (2, 65, 3, 150), (1, 100, 2, 160)]
FLASH_FULL_BWD_SHAPES = [(4, 512, 12, 128), (4, 512, 32, 112),
                         (2, 100, 3, 64), (2, 65, 3, 160), (2, 1, 3, 32),
                         (1, 300, 2, 150)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_FULL_SHAPES)
def test_flash_attention_noncausal_kernel_matches_plain(cuda, shape, dtype):
    """The forward kernel without the causal mask against its plain
    version; one launch, counted apart; a second call gives equal bits."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = _attention_inputs(shape, dtype, cuda)
    before = (flash_attention.launches, flash_attention.noncausal_launches)
    out, lse = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.noncausal_launches) \
        == (before[0] + 1, before[1] + 1)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=False)
    tol = TOLERANCES[dtype][0]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
    again = flash_attention(q, k, v, causal=False)
    assert all(torch.equal(a, b) for a, b in zip((out, lse), again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_FULL_BWD_SHAPES)
def test_flash_attention_noncausal_backward_matches_plain(cuda, shape,
                                                          dtype):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    q, k, v = _attention_inputs(shape, dtype, cuda)
    dout = _attention_inputs(shape, dtype, cuda, seed=1)[0]
    out, lse = flash_attention(q, k, v, causal=False)
    before = (flash_attention_bwd.launches,
              flash_attention_bwd.noncausal_launches)
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    torch.cuda.synchronize()
    assert (flash_attention_bwd.launches,
            flash_attention_bwd.noncausal_launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=False)
    tol = BWD_TOLERANCES[dtype]
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == q.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape", [(2, 100, 3, 64), (1, 65, 2, 160)])
def test_flash_attention_noncausal_takes_grads(cuda, shape):
    """``autograd.grad`` through ``flash_attention(causal=False)``: one
    non-causal forward and backward launch, against autograd through the
    plain forward."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_plain)
    q, k, v = (a.requires_grad_(True)
               for a in _attention_inputs(shape, torch.float32, cuda))
    dout = _attention_inputs(shape, torch.float32, cuda, seed=1)[0]
    before = (flash_attention.noncausal_launches,
              flash_attention_bwd.noncausal_launches)
    out, _ = flash_attention(q, k, v, causal=False)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (flash_attention.noncausal_launches,
            flash_attention_bwd.noncausal_launches) == (before[0] + 1,
                                                        before[1] + 1)
    ref, _ = flash_attention_plain(q, k, v, causal=False)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("hd", [112, 128, 160])
def test_flash_attention_noncausal_kernels_spill_nothing(cuda, hd):
    """The non-causal instantiations of the bf16 kernels spill nothing
    (the forward is the wgmma kernel: 3 warpgroups a block)."""
    from repro_torch.kernels.flash_attention import (bwd_kernel_info,
                                                     kernel_info)
    full = kernel_info(hd, torch.bfloat16, causal=False)
    assert full["spill_bytes"] == 0 and full["threads"] == 384
    for which in ("dkdv", "dq"):
        info = bwd_kernel_info(hd, torch.bfloat16, which, causal=False)
        assert info["spill_bytes"] == 0


# the bf16 forward's wgmma kernel: every padded head dim it tiles apart
# (16 and 32 pad to one 64-column box, 112 and 128 take two, 160 three with
# 64-row kv tiles), S straddling the 128-row q tile and the 64- and 128-row
# kv tiles, and B * H below and above the card's 132 SMs
WGMMA_SHAPES = [(B, S, H, hd) for hd in (16, 32, 64, 112, 128, 160)
                for S in (1, 63, 64, 65, 127, 128, 129, 200, 512)
                for B, H in ((1, 3), (4, 40))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_flash_attention_wgmma_matches_plain(cuda, shape, causal):
    """The wgmma kernel (TMA ring, producer warp, two consumer warpgroups)
    against the plain version in both modes; a second call gives equal
    bits."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     route)
    q, k, v = _attention_inputs(shape, torch.bfloat16, cuda)
    assert route(q, k, v) == "wgmma"
    out, lse = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    tol = TOLERANCES[torch.bfloat16][0]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
    again = flash_attention(q, k, v, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip((out, lse), again))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("what", ["unaligned", "hd 150"])
def test_flash_attention_mma_sync_route_by_shape(cuda, what, causal):
    """Inputs a TMA tensor map cannot describe (a base 2 bytes past a
    16-byte boundary, hd % 8 != 0) take the mma.sync kernel, held to the
    plain version; the same shape aligned at hd 112 takes wgmma; f32 takes
    the CUDA cores."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     route)
    if what == "unaligned":
        shape = (2, 100, 3, 112)
        rng = np.random.default_rng(5)
        flat = [torch.from_numpy(rng.standard_normal(int(np.prod(shape)) + 1)
                                 .astype(np.float32)).to(cuda)
                .to(torch.bfloat16) for _ in range(3)]
        q, k, v = (f[1:].view(shape) for f in flat)
        assert q.data_ptr() % 16 != 0
        assert route(*(a.clone() for a in (q, k, v))) == "wgmma"
    else:
        shape = (2, 100, 3, 150)
        q, k, v = _attention_inputs(shape, torch.bfloat16, cuda)
    assert route(q, k, v) == "mma.sync"
    assert route(*(a.float() for a in (q, k, v))) == "cuda-cores"
    out, lse = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    tol = TOLERANCES[torch.bfloat16][0]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 112, 128, 150, 160])
def test_flash_attention_forward_kernel_info(cuda, hd, causal):
    """At every main-path head dim the bf16 forward is the wgmma kernel:
    384 threads (a producer and two consumer warpgroups), one block an
    SM, no spill; hd 150 reports the mma.sync kernel."""
    from repro_torch.kernels.flash_attention import kernel_info
    info = kernel_info(hd, torch.bfloat16, causal)
    assert info["spill_bytes"] == 0
    if hd % 8:
        assert info["route"] == "mma.sync" and info["threads"] == 256
    else:
        assert info["route"] == "wgmma" and info["threads"] == 384
        assert info["blocks_per_sm"] == 1


def test_checkpoint_restores_onto_an_nccl_mesh(cuda, tmp_path):
    """A checkpoint in the JAX layout (written by the port's store: f32
    moments, bf16 parameters) restored by an NCCL group of one rank onto
    a (1, 1) ``DeviceMesh`` with shardings: DTensors on the card, their
    bits the saved ones."""
    import _torch_ckpt_ranks as ranks
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models.steps import unflatten
    state = ranks.train_state("cpu")
    state["params"] = unflatten(state["params"], [
        t.bfloat16() for _, t in ranks.flatten(state["params"])])
    src = str(tmp_path / "ckpt")
    save_checkpoint(src, ranks.STEP, state)
    got = ranks.spawn(1, "load", (1, 1), str(tmp_path), [src],
                      backend="nccl", device="cuda:0")[0]
    assert int(got["0:step"]) == ranks.STEP
    names = [name for name, _ in ranks.flatten(state)]
    assert any(name.startswith("params/") for name in names)
    for name, leaf in ranks.flatten(state):
        want = ranks.bits(leaf)
        assert got[f"0:{name}"].dtype == want.dtype, name
        np.testing.assert_array_equal(got[f"0:{name}"], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 512, 112, 64, 1, 64),
                                   (1, 100, 3, 16, 1, 8),
                                   (2, 128, 4, 32, 2, 16),
                                   (2, 100, 4, 32, 2, 16),    # chunk 50, G 2
                                   (1, 100, 2, 128, 1, 128),  # N = P = 128
                                   (1, 128, 2, 128, 1, 128),
                                   (2, 128, 4, 128, 2, 128)])
def test_mamba2_ssd_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd, mamba2_ssd_plain
    args = _ssd_inputs(shape, dtype, cuda)
    before = mamba2_ssd.launches
    y, state = mamba2_ssd(*args)
    torch.cuda.synchronize()
    assert mamba2_ssd.launches == before + 1
    ref_y, ref_state = mamba2_ssd_plain(*args)
    tol = TOLERANCES[dtype][1]
    torch.testing.assert_close(y.float(), ref_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, ref_state, atol=tol, rtol=tol)


# the forward's Hopper route, the warpgroup kernel: zamba2's serve shape,
# B H = 112 at 8 chunks, 9 and 16 chunks, G = 2, 3 chunks, one chunk, 5
# chunks at G = 2, 6 heads in 3 groups, B H = 64; beside them chunk 50,
# which keeps mma.sync
SSD_FWD_CASES = [((4, 512, 112, 64, 1, 64), "warpgroup"),
                 ((1, 512, 112, 64, 1, 64), "warpgroup"),
                 ((1, 576, 2, 64, 1, 64), "warpgroup"),
                 ((2, 1024, 4, 64, 2, 64), "warpgroup"),
                 ((2, 192, 8, 64, 1, 64), "warpgroup"),
                 ((1, 64, 3, 64, 1, 64), "warpgroup"),
                 ((2, 320, 4, 64, 2, 64), "warpgroup"),
                 ((1, 448, 6, 64, 3, 64), "warpgroup"),
                 ((1, 512, 64, 64, 1, 64), "warpgroup"),
                 ((4, 100, 112, 64, 1, 64), "mma.sync")]


@pytest.mark.parametrize("shape,route", SSD_FWD_CASES)
def test_ssd_forward_route_matches_plain(cuda, shape, route):
    """The bf16 SSD forward on its route against the plain version, y and
    the final state, at the bf16 tolerance; one launch counted on the
    route; a second call gives equal bits."""
    from repro_torch.kernels import mamba2_ssd
    args = _ssd_inputs(shape, torch.bfloat16, cuda, seed=4)
    assert mamba2_ssd.fwd_route(args[0], args[3], args[4]) == route
    before = mamba2_ssd.mamba2_ssd.routes[route]
    y, state = mamba2_ssd.mamba2_ssd(*args)
    torch.cuda.synchronize()
    assert mamba2_ssd.mamba2_ssd.routes[route] == before + 1
    ref_y, ref_state = mamba2_ssd.mamba2_ssd_plain(*args)
    tol = TOLERANCES[torch.bfloat16][1]
    torch.testing.assert_close(y.float(), ref_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, ref_state, atol=tol, rtol=tol)
    y2, state2 = mamba2_ssd.mamba2_ssd(*args)
    assert torch.equal(y, y2) and torch.equal(state, state2)


def test_ssd_forward_unaligned_view_takes_mma_sync(cuda):
    """x that a TMA map cannot describe (its data 2 bytes past a 16-byte
    boundary) keeps the mma.sync route, within the tolerance."""
    from repro_torch.kernels import mamba2_ssd
    args = _ssd_inputs((1, 128, 2, 64, 1, 64), torch.bfloat16, cuda)
    flat = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    x = flat[1:].view(args[0].shape).copy_(args[0])
    args = [x, *args[1:]]
    assert mamba2_ssd.fwd_route(x, args[3], args[4]) == "mma.sync"
    y, state = mamba2_ssd.mamba2_ssd(*args)
    ref_y, ref_state = mamba2_ssd.mamba2_ssd_plain(*args)
    tol = TOLERANCES[torch.bfloat16][1]
    torch.testing.assert_close(y.float(), ref_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, ref_state, atol=tol, rtol=tol)


def test_ssd_forward_hopper_kernels_fit(cuda):
    """The warpgroup kernel is one warpgroup with no spill and holds 4
    blocks an SM (zamba2's 448 (b, h) in one wave)."""
    from repro_torch.kernels import mamba2_ssd
    info = mamba2_ssd.kernel_info(64, 64, 64, torch.bfloat16, "warpgroup")
    assert info["spill_bytes"] == 0, info
    assert info["threads"] == 128, info
    assert info["blocks_per_sm"] >= 4, info


def _wkv_inputs(shape, dtype, cuda, seed=0):
    B, T, H, N = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = f(B, T, H, N) * 0.5, f(B, T, H, N) * 0.5, f(B, T, H, N) * 0.5
    w = np.exp(-np.exp(f(B, T, H, N) * 0.5 - 2.0))
    u, s0 = f(H, N) * 0.3, f(B, H, N, N) * 0.1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    return [t(r).to(dtype), t(k).to(dtype), t(v).to(dtype), t(w).to(dtype),
            t(u), t(s0)]


# out tolerance of the JAX kernel test (tests/test_kernels.py); state x10
WKV_TOLERANCES = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


# the serve shape (H = 40 at N = 64), chunk 50 (T = 100) and chunk 1
# (T = 97), then the tensor-core route's padding: N = 16, 24 (not a
# multiple of 8: element-wise tile fills), 32 and 5, each with a ragged
# chunk
WKV_SHAPES = [(4, 512, 40, 64), (4, 100, 40, 64), (1, 97, 2, 64),
              (2, 96, 3, 16), (2, 100, 3, 16), (1, 97, 2, 16),
              (2, 100, 3, 24), (1, 97, 2, 24), (2, 128, 4, 24),
              (2, 100, 4, 32), (1, 100, 2, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_rwkv6_wkv_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv, rwkv6_wkv_plain
    args = _wkv_inputs(shape, dtype, cuda)
    before = rwkv6_wkv.launches
    out, state = rwkv6_wkv(*args)
    torch.cuda.synchronize()
    assert rwkv6_wkv.launches == before + 1
    ref_out, ref_state = rwkv6_wkv_plain(*args)
    tol = WKV_TOLERANCES[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(state, ref_state, atol=tol * 10,
                               rtol=tol * 10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_wkv_route_follows_dtype(cuda, dtype):
    """bf16 inputs launch a tensor-core kernel (at N = chunk = 64, aligned,
    the wgmma one) and f32 inputs the CUDA-core one, one launch a call,
    and nothing else on the device."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv
    args = _wkv_inputs((1, 64, 2, 64), dtype, cuda)
    rwkv6_wkv(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rwkv6_wkv(*args)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "wkv" in e.key]
    assert len(names) == 1, names
    assert ("wkv_wg_kernel" in names[0]) == (dtype == torch.bfloat16), names
    assert "wkv_tc_kernel" not in names[0], names


def _wkv_clamped(args, seed=19):
    """The inputs with w drawn to reach both clamps, in separate channels
    (ROADMAP C9): a quarter of the channels decay by e^-0.5..e^-3 a step,
    so the cumsum passes -30 inside a chunk, and the 10th step of every
    chunk has w = 1e-9 in channel N/2 (as chip_smoke.scan_bwd_inputs)."""
    w = args[3]
    B, T, H, N = w.shape
    q = max(1, N // 4)
    rng = np.random.default_rng(seed)
    decay = rng.uniform(0.5, 3.0, (B, T, H, q)).astype(np.float32)
    w[..., :q] = torch.from_numpy(np.exp(-decay)).to(w.device, w.dtype)
    w[:, 9::64, :, N // 2] = 1e-9
    return args


# the forward's wgmma route: rwkv6-3b's serve and train shape, one batch
# row of its heads, and a few heads at 2 chunks
WKV_WGMMA_SHAPES = [(4, 512, 40, 64), (1, 512, 40, 64), (2, 128, 3, 64)]


@pytest.mark.parametrize("draw", ["jax", "clamped"])
@pytest.mark.parametrize("shape", WKV_WGMMA_SHAPES)
def test_wkv_forward_wgmma_route_matches_plain(cuda, shape, draw):
    """The bf16 forward on its wgmma route against the plain version from a
    nonzero state0: out within the bf16 tolerance, the final state within
    the WKV state's (10x); one launch counted on the route; a second call
    gives equal bits."""
    from repro_torch.kernels import rwkv6_wkv as m
    args = _wkv_inputs(shape, torch.bfloat16, cuda, seed=3)
    if draw == "clamped":
        args = _wkv_clamped(args)
    assert m.fwd_route(*args[:4]) == "wgmma"
    before = m.rwkv6_wkv.routes["wgmma"]
    out, state = m.rwkv6_wkv(*args)
    torch.cuda.synchronize()
    assert m.rwkv6_wkv.routes["wgmma"] == before + 1
    ref_out, ref_state = m.rwkv6_wkv_plain(*args)
    tol = WKV_TOLERANCES[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(state, ref_state, atol=tol * 10,
                               rtol=tol * 10)
    out2, state2 = m.rwkv6_wkv(*args)
    assert torch.equal(out, out2) and torch.equal(state, state2)


def test_wkv_forward_wgmma_kernel_fits(cuda):
    """The wgmma kernel is three warpgroups (the products' and two of the
    elementwise pass) with no spill and holds 2 blocks an SM (rwkv6-3b's
    160 (b, h) in one wave on 132 SMs)."""
    from repro_torch.kernels import rwkv6_wkv
    info = rwkv6_wkv.kernel_info(64, 64, torch.bfloat16, "wgmma")
    assert info["spill_bytes"] == 0, info
    assert info["threads"] == 384, info
    assert info["blocks_per_sm"] >= 2, info


@pytest.mark.parametrize("shape", WKV_SHAPES[1:])
def test_wkv_forward_other_bf16_shapes_keep_mma(cuda, shape):
    """A chunk below 64 or N below 64 keeps the mma.sync route, one launch
    counted on it."""
    from repro_torch.kernels import rwkv6_wkv as m
    args = _wkv_inputs(shape, torch.bfloat16, cuda)
    assert m.fwd_route(*args[:4]) == "mma"
    before = m.rwkv6_wkv.routes["mma"]
    m.rwkv6_wkv(*args)
    torch.cuda.synchronize()
    assert m.rwkv6_wkv.routes["mma"] == before + 1


def test_wkv_forward_unaligned_view_takes_mma(cuda):
    """r that a TMA map cannot describe (its data 2 bytes past a 16-byte
    boundary) keeps the mma.sync route, within the tolerance."""
    from repro_torch.kernels import rwkv6_wkv as m
    args = _wkv_inputs((1, 128, 2, 64), torch.bfloat16, cuda)
    flat = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    r = flat[1:].view(args[0].shape).copy_(args[0])
    args = [r, *args[1:]]
    assert m.fwd_route(*args[:4]) == "mma"
    out, state = m.rwkv6_wkv(*args)
    ref_out, ref_state = m.rwkv6_wkv_plain(*args)
    tol = WKV_TOLERANCES[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(state, ref_state, atol=tol * 10,
                               rtol=tol * 10)


@pytest.mark.parametrize("with_dstate", [True, False])
@pytest.mark.parametrize("draw", ["jax", "clamped"])
@pytest.mark.parametrize("shape", WKV_WGMMA_SHAPES)
def test_wkv_backward_wgmma_route_matches_plain(cuda, shape, draw,
                                                with_dstate):
    """The bf16 backward on its wgmma route (the forward's shapes) against
    the plain version, from a nonzero state0, with and without a
    final-state gradient (the train step passes none): every gradient
    within the bf16 gate, in its input's dtype; one launch counted on the
    route; a second call gives equal bits; where w = 1e-9, dw is 0."""
    from repro_torch.kernels import rwkv6_wkv as m
    args, dout, dstate = _scan_inputs("rwkv6_wkv", shape, torch.bfloat16,
                                      cuda, seed=3)
    if draw == "clamped":
        args = _wkv_clamped(args)
    ds = dstate if with_dstate else None
    assert m.bwd_route(*args[:4], dout) == "wgmma"
    before = m.rwkv6_wkv_bwd.routes["wgmma"]
    got = m.rwkv6_wkv_bwd(*args, dout, ds)
    torch.cuda.synchronize()
    assert m.rwkv6_wkv_bwd.routes["wgmma"] == before + 1
    want = m.rwkv6_wkv_bwd_plain(*args, dout, ds)
    tol = BWD_TOLERANCES[torch.bfloat16]
    for a, b, x in zip(got, want, args):
        assert a.dtype == x.dtype and a.shape == x.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
    again = m.rwkv6_wkv_bwd(*args, dout, ds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if draw == "clamped":
        dw = got[3][:, 9::64, :, 32]
        assert torch.equal(dw, torch.zeros_like(dw))


def test_wkv_backward_wgmma_kernel_fits(cuda):
    """The backward's wgmma kernel is three warpgroups (the products' and
    two of the elementwise pass) with no spill, a block an SM."""
    from repro_torch.kernels import rwkv6_wkv
    info = rwkv6_wkv.bwd_kernel_info(64, 64, torch.bfloat16, "wgmma")
    assert info["spill_bytes"] == 0, info
    assert info["threads"] == 384, info
    assert info["blocks_per_sm"] >= 1, info


@pytest.mark.parametrize("shape", [(4, 100, 40, 64), (2, 100, 3, 16),
                                   (2, 128, 4, 32)])
def test_wkv_backward_other_bf16_shapes_keep_mma(cuda, shape):
    """A chunk below 64 or N below 64 keeps the mma.sync walk and chunk
    kernels, one launch counted on that route."""
    from repro_torch.kernels import rwkv6_wkv as m
    args, dout, dstate = _scan_inputs("rwkv6_wkv", shape, torch.bfloat16,
                                      cuda)
    assert m.bwd_route(*args[:4], dout) == "mma"
    before = m.rwkv6_wkv_bwd.routes["mma"]
    m.rwkv6_wkv_bwd(*args, dout, dstate)
    torch.cuda.synchronize()
    assert m.rwkv6_wkv_bwd.routes["mma"] == before + 1


def test_wkv_backward_unaligned_view_takes_mma(cuda):
    """dout that a TMA map cannot describe (its data 2 bytes past a
    16-byte boundary) keeps the mma.sync route, within the gate."""
    from repro_torch.kernels import rwkv6_wkv as m
    args, dout, dstate = _scan_inputs("rwkv6_wkv", (1, 128, 2, 64),
                                      torch.bfloat16, cuda)
    flat = torch.empty(dout.numel() + 1, dtype=torch.bfloat16, device=cuda)
    dout = flat[1:].view(dout.shape).copy_(dout)
    assert m.bwd_route(*args[:4], dout) == "mma"
    got = m.rwkv6_wkv_bwd(*args, dout, dstate)
    want = m.rwkv6_wkv_bwd_plain(*args, dout, dstate)
    tol = BWD_TOLERANCES[torch.bfloat16]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


# --------------------------------------------------------------------------- #
# The fused residual add and RMSNorm (the pre-norms of every bf16 serve path)
# --------------------------------------------------------------------------- #

# (rows, D): chatglm3-6b's prefill and final norm, then each served width
# with many rows (blocks of up to 128 threads) and with few (one vector a
# thread); 3 x 7 x 128 narrower than a warp's vectors
NORM_SHAPES = [(8192, 4096), (4, 4096), (1000, 1536), (3, 1536),
               (1000, 3584), (3, 3584), (1000, 6144), (3, 6144),
               (21, 128), (300, 8192)]


def _norm_inputs(rows, d, cuda, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(rows, d, generator=gen, device=cuda).to(torch.bfloat16)
    delta = (torch.randn(rows, d, generator=gen, device=cuda) * 0.5).to(
        torch.bfloat16)
    scale = torch.rand(d, generator=gen, device=cuda) + 0.5
    return x, delta, scale


def _within_one_ulp(a, b):
    """Two bf16 tensors of one sign pattern differ by at most one unit in
    the last place (their bit patterns by at most 1)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return bool(((ia - ib).abs() <= 1).all())


@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_rms_norm_kernel_matches_the_chain(cuda, shape, with_delta):
    """One launch on the fused route: h the bits of x + delta, y within one
    bf16 ulp of the plain chain run on the card, and the same bits on a
    second call."""
    from repro_torch.kernels import rms_norm as rn
    x, delta, scale = _norm_inputs(*shape, cuda)
    assert rn.fwd_route(x, scale, delta if with_delta else None) == "fused"
    before = (rn.rms_norm.launches, rn.rms_norm.routes["fused"])
    if with_delta:
        h, y = rn.add_rms_norm(x, delta, scale, 1e-5)
        h2, y2 = rn.add_rms_norm(x, delta, scale, 1e-5)
        ref = x + delta
        assert torch.equal(h.view(torch.int16), ref.view(torch.int16))
        assert torch.equal(h2.view(torch.int16), h.view(torch.int16))
    else:
        y = rn.rms_norm(x, scale, 1e-5)
        y2 = rn.rms_norm(x, scale, 1e-5)
        ref = x
    torch.cuda.synchronize()
    assert (rn.rms_norm.launches, rn.rms_norm.routes["fused"]) == (
        before[0] + 2, before[1] + 2)
    assert _within_one_ulp(y, rn.rms_norm_plain(ref, scale, 1e-5))
    assert torch.equal(y2.view(torch.int16), y.view(torch.int16))


@pytest.mark.parametrize("with_delta", [True, False])
def test_rms_norm_kernel_takes_strided_rows(cuda, with_delta):
    """The final norm's rows h[:, -1:] of a (4, 300, 4096) prefill, row
    stride 300 x 4096, as they are (no copy)."""
    from repro_torch.kernels import rms_norm as rn
    x, delta, scale = _norm_inputs(4 * 300, 4096, cuda, seed=1)
    last = x.view(4, 300, 4096)[:, -1:]
    d_last = delta.view(4, 300, 4096)[:, -1:]
    assert not last.is_contiguous() and rn._row_stride(last) == 300 * 4096
    if with_delta:
        h, y = rn.add_rms_norm(last, d_last, scale, 1e-5)
        ref = last + d_last
        assert torch.equal(h.view(torch.int16), ref.view(torch.int16))
    else:
        y, ref = rn.rms_norm(last, scale, 1e-5), last
    assert y.shape == (4, 1, 4096) and y.is_contiguous()
    assert _within_one_ulp(y, rn.rms_norm_plain(ref, scale, 1e-5))


def test_rms_norm_refused_launch_raises(cuda):
    """Past the route, the launcher's own checks refuse a shape it does not
    take, and the wrapper raises: nothing falls back."""
    from repro_torch.kernels import rms_norm as rn
    x, _, scale = _norm_inputs(4, 4096, cuda)
    with pytest.raises(RuntimeError, match="rms_norm kernel launch failed"):
        # rows of 4092, 8 bytes past an aligned base
        rn._launch(x[:, 4:], None, scale[4:], 1e-5)


@pytest.mark.parametrize("shape", [(8192, 4096), (4, 4096), (8192, 8192),
                                   (4, 8192), (1000, 3584), (1000, 6144)])
def test_rms_norm_kernel_fits(cuda, shape):
    """No spill, with and without the add; blocks of up to 128 threads
    with many rows (at least 4 an SM), one thread a vector with few."""
    from repro_torch.kernels import rms_norm as rn
    for with_delta in (True, False):
        info = rn.kernel_info(*shape, with_delta)
        assert info["spill_bytes"] == 0, (shape, with_delta, info)
        if shape[0] > 264:
            assert info["threads"] <= 128, info
            assert info["blocks_per_sm"] >= 4, info
        else:
            assert info["threads"] == shape[1] // 8, info


def test_chatglm3_smoke_prefill_on_the_fused_route(cuda, monkeypatch):
    """chatglm3-6b's smoke configuration served on the card: every norm
    of the prefill on the fused route (2 a layer and the final one), the
    session's stats counting them, and its logits within the serve tests'
    tolerance of the same prefill with every norm on the plain chain."""
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.launch.serve import ServeSession
    cpu = ServeSession("chatglm3-6b", smoke=True, device="cpu")
    gpu = ServeSession("chatglm3-6b", smoke=True, device=cuda,
                       params=_to(cpu.params, cuda))
    n = 2 * gpu.cfg.n_layers + 1
    tokens = np.random.default_rng(0).integers(0, gpu.cfg.vocab_size,
                                                (4, 100))
    batch = {"inputs": torch.from_numpy(tokens).to(cuda)}
    before = (rn.rms_norm.launches, dict(rn.rms_norm.routes))
    lg, _ = gpu.prefill(gpu.params, batch)
    torch.cuda.synchronize()
    assert rn.rms_norm.launches - before[0] == n
    assert rn.rms_norm.routes["fused"] - before[1].get("fused", 0) == n
    assert rn.rms_norm.routes["plain"] == before[1].get("plain", 0)
    gpu.generate(tokens, 4)
    assert gpu.stats[-1]["rms_norm_launches"] == n
    monkeypatch.setattr(rn, "fwd_route", lambda *a, **k: "plain")
    launches = rn.rms_norm.launches
    lp, _ = gpu.prefill(gpu.params, batch)
    assert rn.rms_norm.launches == launches
    torch.testing.assert_close(lg, lp, atol=0.08, rtol=0.05)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen2-vl-2b"])
def test_train_step_launches_no_norm(cuda, arch):
    """Under grad every norm keeps the plain chain: a bf16 smoke train
    step launches no norm kernel."""
    from repro_torch.data import make_stream
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.models import steps
    from repro_torch.models.config import get_config
    cfg = get_config(arch, smoke=True)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_stream(cfg, 64, 2).batch(0).items()}
    state = steps.init_train_state(cfg, 0, cuda)
    before = (rn.rms_norm.launches, rn.rms_norm.routes["fused"],
              rn.rms_norm.routes["plain"])
    state, metrics = steps.make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert (rn.rms_norm.launches, rn.rms_norm.routes["fused"]) == before[:2]
    assert rn.rms_norm.routes["plain"] > before[2]


def test_zamba2_smoke_serve_on_card_matches_cpu(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.config import get_config
    from repro_torch.models.transformer import init_params
    # the same weights on both devices: drawn once, then copied
    params = init_params(get_config("zamba2-7b", smoke=True), 0,
                         torch.bfloat16, "cpu")
    cpu = ServeSession("zamba2-7b", smoke=True, device="cpu", params=params)
    gpu = ServeSession("zamba2-7b", smoke=True, device=cuda,
                       params=_to(params, cuda))
    tokens = np.random.default_rng(0).integers(0, cpu.cfg.vocab_size,
                                                (2, 100))
    before = (flash_attention.launches, mamba2_ssd.launches)
    lg, _ = gpu.prefill(gpu.params, {"inputs": torch.from_numpy(tokens)
                                     .to(cuda)})
    torch.cuda.synchronize()
    cfg = gpu.cfg
    assert flash_attention.launches - before[0] == \
        cfg.n_layers // cfg.attn_every
    assert mamba2_ssd.launches - before[1] == cfg.n_layers
    lc, _ = cpu.prefill(cpu.params, {"inputs": torch.from_numpy(tokens)})
    torch.testing.assert_close(lg.cpu(), lc, atol=0.08, rtol=0.05)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_rwkv6_smoke_serve_on_card_matches_cpu(cuda):
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.config import get_config
    from repro_torch.models.transformer import init_params
    params = init_params(get_config("rwkv6-3b", smoke=True), 0,
                         torch.bfloat16, "cpu")
    cpu = ServeSession("rwkv6-3b", smoke=True, device="cpu", params=params)
    gpu = ServeSession("rwkv6-3b", smoke=True, device=cuda,
                       params=_to(params, cuda))
    tokens = np.random.default_rng(0).integers(0, cpu.cfg.vocab_size,
                                                (2, 100))
    before = rwkv6_wkv.launches
    lg, _ = gpu.prefill(gpu.params, {"inputs": torch.from_numpy(tokens)
                                     .to(cuda)})
    torch.cuda.synchronize()
    assert rwkv6_wkv.launches - before == gpu.cfg.n_layers
    lc, _ = cpu.prefill(cpu.params, {"inputs": torch.from_numpy(tokens)})
    torch.testing.assert_close(lg.cpu(), lc, atol=0.08, rtol=0.05)


def test_dense_smoke_serve_on_card_matches_cpu(cuda):
    """minitron-4b's smoke configuration, the same weights on both
    devices: prefill launches flash once a layer; logits and greedy tokens
    of a short generation agree with the CPU's."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.config import get_config
    from repro_torch.models.transformer import init_params
    params = init_params(get_config("minitron-4b", smoke=True), 0,
                         torch.bfloat16, "cpu")
    cpu = ServeSession("minitron-4b", smoke=True, device="cpu",
                       params=params)
    gpu = ServeSession("minitron-4b", smoke=True, device=cuda,
                       params=_to(params, cuda))
    tokens = np.random.default_rng(0).integers(0, cpu.cfg.vocab_size,
                                                (2, 100))
    before = flash_attention.launches
    lg, cg = gpu.prefill(gpu.params, {"inputs": torch.from_numpy(tokens)
                                      .to(cuda)})
    torch.cuda.synchronize()
    assert flash_attention.launches - before == gpu.cfg.n_layers
    lc, cc = cpu.prefill(cpu.params, {"inputs": torch.from_numpy(tokens)})
    torch.testing.assert_close(lg.cpu(), lc, atol=0.08, rtol=0.05)
    torch.testing.assert_close(cg["k"].cpu().float(), cc["k"].float(),
                               atol=0.08, rtol=0.05)
    out = gpu.generate(tokens, 4)
    assert out.shape == (2, 4)
    assert ((out >= 0) & (out < gpu.cfg.vocab_size)).all()
    assert gpu.stats[-1]["flash_attention_launches"] == gpu.cfg.n_layers


def test_qwen2_vl_smoke_prefill_on_embeddings_matches_cpu(cuda):
    """qwen2-vl's smoke configuration on bf16 embeddings with distinct
    (B, 3, S) M-RoPE position streams, on the card against the CPU, then
    one decode step on an embedding."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import _merge_cache
    from repro_torch.models import steps, transformer
    from repro_torch.models.config import get_config
    cfg = get_config("qwen2-vl-2b", smoke=True)
    params = transformer.init_params(cfg, 0, torch.bfloat16, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 100, cfg.d_model))
                         .astype(np.float32)).bfloat16()
    pos = torch.from_numpy(rng.integers(0, 400, (2, 3, 100))
                           .astype(np.int32))
    tok = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model))
                           .astype(np.float32)).bfloat16()
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)

    def run(device, tree):
        before = flash_attention.launches
        logits, cache = prefill(tree, {"inputs": x.to(device),
                                       "positions": pos.to(device)})
        launched = flash_attention.launches - before
        full = _merge_cache(transformer.init_cache(cfg, 2, 101, device),
                            cache)
        step, _ = decode(tree, tok.to(device), full)
        return logits.cpu(), step.cpu(), launched

    lg, sg, launched = run(cuda, _to(params, cuda))
    torch.cuda.synchronize()
    assert launched == cfg.n_layers
    lc, sc, _ = run("cpu", params)
    assert bool(torch.isfinite(lg).all()) and bool(torch.isfinite(sg).all())
    torch.testing.assert_close(lg, lc, atol=0.08, rtol=0.05)
    torch.testing.assert_close(sg, sc, atol=0.08, rtol=0.05)


def test_default_service_resolves_to_cuda(cuda):
    from repro_torch.serve import EnsembleService
    svc = EnsembleService().start()
    try:
        rts = svc.amgr.emgr.rts
        assert rts._devices and all(d.type == "cuda" for d in rts._devices)
    finally:
        svc.stop()


def test_two_tenant_service_sweep_launches_once_a_carrier(cuda):
    """Two tenants' ``analog_values`` sweeps through the service on the
    card share carriers, each of which launches the distance kernel once
    at its whole width; the values equal the CPU service's."""
    from repro_torch import api
    from repro_torch.apps.anen import workflow as wf
    from repro_torch.device import device_name
    from repro_torch.fusion.handles import to_host
    from repro_torch.kernels.anen_distance import anen_distance
    from repro_torch.rts.base import ResourceDescription
    from repro_torch.rts.torch_rts import CARRIERS_TOTAL
    from repro_torch.serve import EnsembleService

    def sweep(tenant, device):
        rng = np.random.default_rng(1000 + tenant)
        return [dict(seed=0, ny=20, nx=20, n_hist=30, k=12, device=device,
                     locations=np.stack(np.divmod(rng.choice(400, 16,
                                                             replace=False),
                                                  20), axis=1).tolist())
                for _ in range(4)]

    def serve(device):
        svc = EnsembleService(resources=ResourceDescription(slots=4),
                              serve_hold_s=0.25, device=device).start()
        try:
            before = anen_distance.launches
            hs = [svc.submit(api.ensemble(wf.analog_values,
                                          over=sweep(t, device_name(device)),
                                          name="av"), tenant=f"t{t}")
                  for t in range(2)]
            assert all(h.wait(120) and h.succeeded() for h in hs)
            torch.cuda.synchronize()
            rts = svc.amgr.emgr.rts
            out = {"launches": anen_distance.launches - before,
                   "carriers": rts.metrics.counter(CARRIERS_TOTAL,
                                                   tier="fused").value,
                   "stats": rts.fusion_stats,
                   "values": [to_host(h.result(f"av-{i}"))
                              for h in hs for i in range(4)]}
        finally:
            svc.stop()
        return out

    on_gpu, on_cpu = serve(cuda), serve("cpu")
    assert on_gpu["carriers"] >= 1
    assert on_gpu["launches"] == on_gpu["carriers"]
    assert on_gpu["stats"]["cross_tenant_carriers"] >= 1
    assert on_gpu["stats"]["scalar_fallback"] == 0
    assert on_gpu["stats"]["degraded"] == 0
    for g, c in zip(on_gpu["values"], on_cpu["values"]):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-6)


def test_qwen2_vl_smoke_train_step_on_card_matches_cpu(cuda):
    """One train step of qwen2-vl's smoke configuration (M-RoPE positions,
    embeddings from the data stream, S = 100: a ragged last flash tile)
    from the same f32 state on the card and on the CPU: the flash forward
    twice and its backward once a layer on the card; loss at the model
    tolerance, grad norm at rtol 0.05 (bf16 sums in another order); the
    moments m̂ and √v̂ (the clipped gradient and its magnitude) leaf by leaf
    at a normwise rtol 0.05 (bf16 against f32 compute on the CPU differs
    by at most 0.02 a leaf here); and on each side every parameter written
    from its own moments (``tests/_torch_update.py``: step 1 moves each by
    about ±lr = 3e-6, below any tolerance on the parameters)."""
    from _torch_update import (assert_update_written, clone_tree,
                               moments_rel_err)
    from repro_torch.data import make_stream
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.models import steps
    from repro_torch.models.config import get_config
    cfg = get_config("qwen2-vl-2b", smoke=True)
    batch = {k: torch.from_numpy(v)
             for k, v in make_stream(cfg, 100, 4).batch(0).items()}
    cpu = steps.init_train_state(cfg, 0, "cpu")
    gpu = _to(cpu, cuda)
    params0 = clone_tree(cpu["params"])
    step = steps.make_train_step(cfg)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    gpu, mg = step(gpu, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0],
            flash_attention_bwd.launches - before[1]) == (
        2 * cfg.n_layers, cfg.n_layers)
    cpu, mc = step(cpu, batch)
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               atol=0.08, rtol=0.05)
    np.testing.assert_allclose(float(mg["grad_norm"]),
                               float(mc["grad_norm"]), rtol=0.05)
    assert moments_rel_err(gpu["opt"], cpu["opt"]) <= 0.05
    assert_update_written(params0, gpu["params"], gpu["opt"],
                          float(mg["lr"]))
    assert_update_written(params0, cpu["params"], cpu["opt"],
                          float(mc["lr"]))


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_scan_smoke_train_step_on_card_matches_cpu(cuda, arch):
    """One train step of zamba2's (SSD and the shared flash block) and
    rwkv6's (WKV) smoke configurations from the same f32 state on the card
    and on the CPU, S = 100 (chunk 50): on the card each scan's forward
    twice and its backward once a layer (one checkpoint a layer); loss,
    grad norm, moments and each parameter's write held as in the qwen2-vl
    test above."""
    from _torch_update import (assert_update_written, clone_tree,
                               moments_rel_err)
    from repro_torch.data import make_stream
    from repro_torch.kernels import KERNELS
    from repro_torch.models import steps
    from repro_torch.models.config import get_config
    cfg = get_config(arch, smoke=True)
    batch = {k: torch.from_numpy(v)
             for k, v in make_stream(cfg, 100, 4).batch(0).items()}
    cpu = steps.init_train_state(cfg, 0, "cpu")
    gpu = _to(cpu, cuda)
    params0 = clone_tree(cpu["params"])
    step = steps.make_train_step(cfg)
    before = {k: fn.launches for k, fn in KERNELS.items()}
    gpu, mg = step(gpu, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    launched = {k: fn.launches - before[k] for k, fn in KERNELS.items()}
    L = cfg.n_layers
    attn = L // cfg.attn_every if cfg.family == "hybrid" else 0
    scan = "mamba2_ssd" if cfg.family == "hybrid" else "rwkv6_wkv"
    want = {k: 0 for k in KERNELS}
    want.update({scan: 2 * L, scan + "_bwd": L,
                 "flash_attention": 2 * attn, "flash_attention_bwd": attn})
    assert launched == want
    cpu, mc = step(cpu, batch)
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               atol=0.08, rtol=0.05)
    np.testing.assert_allclose(float(mg["grad_norm"]),
                               float(mc["grad_norm"]), rtol=0.05)
    assert moments_rel_err(gpu["opt"], cpu["opt"]) <= 0.05
    assert_update_written(params0, gpu["params"], gpu["opt"],
                          float(mg["lr"]))
    assert_update_written(params0, cpu["params"], cpu["opt"],
                          float(mc["lr"]))


MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]


def _equal_bits(a, b):
    if isinstance(a, dict):
        return all(_equal_bits(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _f32_routes(monkeypatch):
    """Compute in f32 and record every MoE layer's chosen experts (on the
    host, in call order). In bf16 a rounding difference between the
    devices in a router's input flips near-tied choices and moves a
    token's output by a whole expert, so the card is held to the CPU in
    f32, the chosen experts first."""
    from repro_torch.models import moe, transformer
    routes = []
    route = moe._route

    def recorded(x2d, router, cfg):
        out = route(x2d, router, cfg)
        routes.append(out[1].cpu())
        return out
    monkeypatch.setattr(moe, "_route", recorded)
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    return routes


def _assert_routes_equal(routes, n):
    assert n and len(routes) == 2 * n
    assert all(torch.equal(a, b) for a, b in zip(routes[:n], routes[n:]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_smoke_serve_on_card_matches_cpu(cuda, arch, monkeypatch):
    """The MoE smoke configurations in bf16 on the card: prefill launches
    flash once a layer, a second prefill gives the same bits (a
    deterministic dispatch and combine), and a short generation stays in
    the vocabulary. Then in f32, the same weights on both devices: the
    chosen experts equal the CPU's, layer by layer, and the logits and
    cache agree within 1e-3."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.config import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch, smoke=True)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 100))
    batch = {"inputs": torch.from_numpy(tokens).to(cuda)}
    gpu = ServeSession(arch, smoke=True, device=cuda)
    before = flash_attention.launches
    lg, cg = gpu.prefill(gpu.params, batch)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == cfg.n_layers
    lg2, cg2 = gpu.prefill(gpu.params, batch)
    assert torch.equal(lg, lg2) and _equal_bits(cg, cg2)
    out = gpu.generate(tokens, 4)
    assert out.shape == (4, 4)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    assert gpu.stats[-1]["flash_attention_launches"] == cfg.n_layers

    routes = _f32_routes(monkeypatch)
    params = init_params(cfg, 0, torch.float32, "cpu")
    cpu = ServeSession(arch, smoke=True, device="cpu", params=params)
    gpu = ServeSession(arch, smoke=True, device=cuda,
                       params=_to(params, cuda))
    lg, cg = gpu.prefill(gpu.params, batch)
    n = len(routes)
    lc, cc = cpu.prefill(cpu.params, {"inputs": torch.from_numpy(tokens)})
    _assert_routes_equal(routes, n)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(cg["k"].cpu(), cc["k"], atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_smoke_train_step_on_card_matches_cpu(cuda, arch, monkeypatch):
    """The MoE smoke configurations' train step, S = 100. In bf16 on the
    card, the loss and every gradient of a second pass from the same
    state give the same bits as a first (no atomic in the combine or its
    backward). Then one step in f32 from the same state on the card and
    on the CPU: flash's forward twice and its backward once a layer on the
    card, the chosen experts equal the CPU's, loss, grad norm and moments
    within 1e-3, and each parameter's write held as in the qwen2-vl test
    above."""
    from _torch_update import (assert_update_written, clone_tree,
                               moments_rel_err)
    from repro_torch.data import make_stream
    from repro_torch.kernels import KERNELS
    from repro_torch.models import steps
    from repro_torch.models.config import get_config
    cfg = get_config(arch, smoke=True)
    batch = {k: torch.from_numpy(v)
             for k, v in make_stream(cfg, 100, 4).batch(0).items()}
    gbatch = {k: v.to(cuda) for k, v in batch.items()}
    cpu = steps.init_train_state(cfg, 0, "cpu")
    gpu = _to(cpu, cuda)

    def grads():
        params = clone_tree(gpu["params"])
        leaves = steps.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = steps.loss_fn(params, cfg, gbatch)
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))

    first, second = grads(), grads()
    assert all(torch.equal(a, b) for a, b in zip(first, second))

    routes = _f32_routes(monkeypatch)
    params0 = clone_tree(cpu["params"])
    step = steps.make_train_step(cfg)
    before = {k: fn.launches for k, fn in KERNELS.items()}
    gpu, mg = step(gpu, gbatch)
    torch.cuda.synchronize()
    n = len(routes)
    launched = {k: fn.launches - before[k] for k, fn in KERNELS.items()}
    want = {k: 0 for k in KERNELS}
    want.update(flash_attention=2 * cfg.n_layers,
                flash_attention_bwd=cfg.n_layers)
    assert launched == want
    cpu, mc = step(cpu, batch)
    _assert_routes_equal(routes, n)
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(float(mg["grad_norm"]),
                               float(mc["grad_norm"]), rtol=1e-3)
    assert moments_rel_err(gpu["opt"], cpu["opt"]) <= 1e-3
    assert_update_written(params0, gpu["params"], gpu["opt"],
                          float(mg["lr"]))
    assert_update_written(params0, cpu["params"], cpu["opt"],
                          float(mc["lr"]))


# --------------------------------------------------------------------------- #
# int8 gradient compression and the dry-run tier on the card
# --------------------------------------------------------------------------- #

def test_int8_compression_on_card_equals_cpu_bits(cuda):
    from repro_torch.optim import compression
    gen = torch.Generator().manual_seed(1)
    g = torch.randn((1 << 20) + 77, generator=gen) * 5.0
    g[:2048] *= 1e-14                  # a block at the scale's floor
    qc, sc = compression.compress_int8(g)
    qg, sg = compression.compress_int8(g.to(cuda))
    assert torch.equal(qg.cpu(), qc)
    assert torch.equal(sg.cpu().view(torch.int32), sc.view(torch.int32))
    err = compression.init_error({"w": g.to(cuda)})
    new_g, new_e = compression.ef_compressed_mean({"w": g.to(cuda)}, err)
    cg, ce = compression.ef_compressed_mean(
        {"w": g}, compression.init_error({"w": g}))
    assert torch.equal(new_g["w"].cpu().view(torch.int32),
                       cg["w"].view(torch.int32))
    assert torch.equal(new_e["w"].cpu().view(torch.int32),
                       ce["w"].view(torch.int32))


def test_int8_train_session_on_card(cuda):
    from repro_torch.launch import train
    from repro_torch.optim.adamw import leaves
    kw = dict(arch="minitron-4b", smoke=True, seq_len=32, global_batch=2,
              device="cuda")
    plain = train.TrainSession(**kw)
    comp = train.TrainSession(grad_compression="int8", **kw)
    plain.run_steps(2, save=False)
    comp.run_steps(2, save=False)
    assert [r["loss"] for r in comp.stats] == [r["loss"] for r in
                                                plain.stats]
    errs = leaves(comp.error_state)
    assert len(errs) == len(leaves(comp.state["params"]))
    assert all(e.is_cuda and e.dtype == torch.float32 and not e.any()
               for e in errs)


def test_one_device_dryrun_predicts_a_real_step(cuda):
    """minitron-4b at its published width, 2 layers, one train step of 2 x
    256: the dry-run's peak within 15 % of ``max_memory_allocated``, its
    flash launches exact, its matmul FLOPs within 1e-6 of
    ``FlopCounterMode``'s."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.dryrun import cell_record
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.op_analysis import matmul_flops_of
    from repro_torch.models import steps
    from repro_torch.models.config import ShapeConfig, get_config
    from repro_torch.models.input_specs import input_specs
    cfg = get_config("minitron-4b", n_layers=2)
    shape = ShapeConfig("t", 256, 2, "train")
    rec = cell_record("minitron-4b", "t", Mesh(("data", "model"), (1, 1)),
                      device="cuda", cfg=cfg, shape=shape)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    state = steps.init_train_state(cfg, 0, cuda)
    specs = input_specs(cfg, shape)["batch"]
    batch = {k: torch.randint(0, cfg.vocab_size, v.shape, device=cuda,
                              dtype=torch.int32) for k, v in specs.items()}
    fn = steps.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: f.launches for k, f in KERNELS.items()}
    fn(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    got = {k: f.launches - before[k] for k, f in KERNELS.items()
           if f.launches != before[k]}
    pred = rec["memory"]["peak_bytes_per_device"]
    assert abs(pred - peak) / peak <= 0.15, (pred, peak)
    assert got == {"flash_attention": rec["launches"]["flash_fwd"],
                   "flash_attention_bwd": rec["launches"]["flash_bwd"]}
    flops = matmul_flops_of(fn, state, batch)
    assert abs(rec["per_device"]["matmul_flops"] - flops) <= 1e-6 * flops


# --------------------------------------------------------------------------- #
# The sharded tier over lanes of one card (and over two cards, where there
# are two)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(365, 3, 1024), (365, 3, 510),
                                   (37, 3, 20)])
def test_sharded_distance_on_lanes_bit_equal_to_b1(cuda, shape):
    """B2 on 4 lanes of the card: B1's kernel once per lane on its own
    stream, the gathered result bit-equal to B1 over the whole H (365 %
    4 != 0: edge rows padded)."""
    from repro_torch.device import virtual_devices
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_sharded)
    h, v, n = shape
    rng = np.random.default_rng(9)
    fh = torch.from_numpy(rng.standard_normal((h, v, n)).astype(
        np.float32)).to(cuda)
    fn = torch.from_numpy(rng.standard_normal((v, n)).astype(
        np.float32)).to(cuda)
    lanes = virtual_devices("cuda", 4)
    b1 = anen_distance.launches
    b2 = anen_distance_sharded.launches
    got = anen_distance_sharded(fh, fn, lanes)
    torch.cuda.synchronize()
    assert anen_distance.launches == b1 + 4
    assert anen_distance_sharded.launches == b2 + 4
    assert torch.equal(got, anen_distance(fh, fn))


def test_anen_sharded_on_lanes_equals_unsharded(cuda):
    """AnEn at smoke size, 16 members over 4 lanes of the card: one
    shard carrier a round, one distance launch a lane, the values of the
    same description run with ``shard=False`` on the card."""
    from repro_torch.apps.anen.workflow import run_random
    from repro_torch.device import virtual_devices
    from repro_torch.kernels.anen_distance import anen_distance
    kw = dict(device="cuda", seed=3, ny=20, nx=20, n_hist=30, per_iter=128,
              max_iters=2, n_tasks=16, slots=4,
              places=virtual_devices("cuda", 4))
    before = anen_distance.launches
    got = run_random(shard_min_members=16, **kw)
    launched = anen_distance.launches - before
    ref = run_random(shard=False, **kw)
    assert got["all_done"] and ref["all_done"]
    stats = got["fusion_stats"]
    assert stats["shard_carriers"] == 2 and stats["degraded"] == 0
    assert launched == 4 * 2
    assert ref["fusion_stats"]["shard_carriers"] == 0
    assert got["values"] == ref["values"]
    assert got["errors"] == ref["errors"]


def test_seismic_sharded_dag_on_lanes_matches_unsharded(cuda):
    """8 sources over 4 lanes, 2 a lane: misfits within 1e-6 relative of
    the unsharded run's, not bit-equal — the vmapped misfit sum's
    reduction order on the card follows the batch width (2 members
    against 8). At the card check's 16 a lane they are bit-equal
    (``chip_smoke.py``)."""
    from repro_torch.apps.seismic.workflow import run_misfit_chain
    from repro_torch.device import virtual_devices
    kw = dict(nx=32, nt=60, seed=0, dv=25.0, device="cuda",
              places=virtual_devices("cuda", 4), shard_min_members=8)
    got = run_misfit_chain(8, 4, **kw)
    ref = run_misfit_chain(8, 4, shard=False, **kw)
    assert got["all_done"] and ref["all_done"]
    assert got["fusion_stats"]["shard_carriers"] == 1
    assert ref["fusion_stats"]["shard_carriers"] == 0
    assert max(abs(a - b) / abs(b)
               for a, b in zip(got["misfits"], ref["misfits"])) <= 1e-6
    assert abs(got["total_misfit"] - ref["total_misfit"]) <= \
        1e-4 * abs(ref["total_misfit"])


def test_sharded_distinct_cards(cuda):
    """The sharded tier over two real cards: peer copies of the shards
    and a launch context per card. Skips below two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: peer copies and per-card "
                    "launch contexts are unverified on one card")
    from repro_torch.apps.anen.workflow import run_random
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_sharded)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    rng = np.random.default_rng(10)
    fh = torch.from_numpy(rng.standard_normal((365, 3, 510)).astype(
        np.float32)).to(cards[0])
    fn = torch.from_numpy(rng.standard_normal((3, 510)).astype(
        np.float32)).to(cards[0])
    got = anen_distance_sharded(fh, fn, cards)
    assert got.device == cards[0]
    assert torch.equal(got, anen_distance(fh, fn))
    kw = dict(device="cuda:0", seed=3, ny=20, nx=20, n_hist=30,
              per_iter=128, max_iters=2, n_tasks=16, slots=2, places=cards)
    sharded = run_random(shard_min_members=16, **kw)
    plain = run_random(shard=False, **kw)
    assert sharded["fusion_stats"]["shard_carriers"] == 2
    assert sharded["values"] == plain["values"]


# --------------------------------------------------------------------------- #
# The sharded tier's link graphs, and the data-axis mean of int8 compression
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def graphed_sweeps():
    """The seismic sharded DAG (16 sources over 4 lanes) three times from
    an empty graph store: eager and captured, then replayed twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.apps.seismic.workflow import run_misfit_chain
    from repro_torch.device import virtual_devices
    from repro_torch.fusion import engine
    engine.release_graphs()
    kw = dict(nx=32, nt=60, seed=0, dv=25.0, device="cuda",
              places=virtual_devices("cuda", 4), shard_min_members=8)
    return [run_misfit_chain(16, 4, **kw) for _ in range(3)]


def test_graphed_sharded_link_bit_equal_to_eager(graphed_sweeps):
    """The first sweep runs each lane's links eagerly, then captures them;
    the replays give its misfits bit for bit."""
    first, *replayed = graphed_sweeps
    for run in graphed_sweeps:
        assert run["all_done"]
        assert run["fusion_stats"]["shard_carriers"] == 1
        assert run["fusion_stats"]["degraded"] == 0
    for run in replayed:
        assert run["misfits"] == first["misfits"]
        assert run["total_misfit"] == first["total_misfit"]


def test_a_second_sweep_replays_without_a_new_capture(graphed_sweeps):
    stats = [{k: run["fusion_stats"][k] for k in ("graph_captures",
                                                  "graph_replays",
                                                  "graph_refusals")}
             for run in graphed_sweeps]
    # 4 lanes x 2 links (forward, misfit)
    assert stats[0] == {"graph_captures": 8, "graph_replays": 0,
                        "graph_refusals": 0}
    assert stats[1] == stats[2] == {"graph_captures": 0,
                                    "graph_replays": 8,
                                    "graph_refusals": 0}


def test_a_link_with_a_host_sync_is_refused_and_runs_eagerly(cuda):
    """``.item()`` inside a link cannot be captured: the link runs eagerly
    on every call, each call counted in ``graph_refusals``, with the
    eager values."""
    from repro_torch import api
    from repro_torch.device import virtual_devices
    from repro_torch.fusion import engine, fusable, fusable_reduction
    from repro_torch.rts.base import ResourceDescription
    from repro_torch.rts.torch_rts import TorchRTS

    @fusable()
    def k_host_sync(x):
        x = torch.as_tensor(x, dtype=torch.float32)
        scale = torch.full((), 2.0, device=x.device).item()   # a sync
        return x * scale + 1.0

    @fusable_reduction(kind="sum")
    def r_sum(values):
        raise RuntimeError("the scalar body must not run")

    engine.release_graphs()
    runs = []
    for _ in range(2):
        ens = api.ensemble(k_host_sync,
                           over=[{"x": float(i)} for i in range(16)],
                           name="sync")
        obj = api.gather(ens, r_sum, name="sync-sum")
        holder = {}

        def factory():
            holder["rts"] = TorchRTS(device="cuda",
                                     devices=virtual_devices("cuda", 4),
                                     shard_min_members=8)
            return holder["rts"]

        res = api.run(obj, resources=ResourceDescription(slots=4),
                      rts_factory=factory, timeout=120)
        assert res.all_done
        runs.append((float(obj.out.result()),
                     [float(s.out.result()) for s in ens.specs],
                     holder["rts"].fusion_stats))
        res.close()
    for total, members, stats in runs:
        assert stats["shard_carriers"] == 1 and stats["degraded"] == 0
        assert stats["graph_refusals"] == 4
        assert stats["graph_captures"] == stats["graph_replays"] == 0
        assert members == [2.0 * i + 1.0 for i in range(16)]
        assert total == sum(2.0 * i + 1.0 for i in range(16))


def test_compressed_mean_over_an_nccl_group_of_one(cuda, tmp_path):
    """``ef_compressed_mean(axis_name="data")`` over an NCCL group of world
    size 1 on CUDA tensors (a process of its own): the CPU's error bits
    and its mean, which for one rank is the rank's own payload."""
    import _torch_ranks as ranks
    got = ranks.spawn(1, "nccl", "cuda:0", str(tmp_path), cases=("world",))
    want = ranks.expected(1, "world")
    assert sorted(got[0]) == sorted(want[0])
    for key, v in want[0].items():
        np.testing.assert_array_equal(got[0][key].view(np.uint32),
                                      v.view(np.uint32))
