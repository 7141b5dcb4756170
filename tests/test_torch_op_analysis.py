"""The port's op-by-op roofline counter (``repro_torch.launch.op_analysis``,
the counterpart of the JAX package's ``hlo_analysis``) and the kernels'
cost formulas (``repro_torch.kernels.costs``): dot FLOPs exact, a copy's
bytes right, the roofline arithmetic on the H100 spec-sheet peaks, the
collectives' ring factors and mesh axes on a 4-rank fake process group
(in a subprocess: the process group is process state), each kernel op one
launch with its formula on fake tensors, and the formulas equal to the
bounds ``chip_smoke.py`` printed for the main-path shapes before they
moved into the package."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import costs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba2_ssd import mamba2_ssd
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv
from repro_torch.launch import op_analysis as oa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dot_flops_exact():
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    res = oa.analyze(lambda: a @ b)
    assert res["flops"] == res["matmul_flops"] == 2 * 32 * 48 * 16
    assert oa.matmul_flops_of(lambda: a @ b) == 2 * 32 * 48 * 16
    x = torch.randn(3, 32, 48)
    res = oa.analyze(lambda: torch.bmm(x, x.transpose(1, 2)))
    assert res["matmul_flops"] == 2 * 3 * 32 * 32 * 48


def test_bytes_of_a_copy_and_free_views():
    n = 1 << 16
    x = torch.randn(n)
    res = oa.analyze(lambda: x * 2.0)
    assert res["bytes"] == 2 * n * 4          # one read, one write
    assert res["flops"] == n                  # one a element
    res = oa.analyze(lambda: x.view(256, 256).t()[:10])
    assert res["flops"] == res["bytes"] == 0  # views are free
    # the reshape of a transposed view copies: read + write once, one
    # operation an element (JAX's rule for any op but a dot)
    res = oa.analyze(lambda: x.view(256, 256).t().reshape(-1))
    assert res["bytes"] == 2 * n * 4 and res["flops"] == n


def test_memory_tracks_live_bytes_and_peak():
    a = torch.randn(64, 128)
    mode = oa.OpAnalysis()
    mode.track(a)
    with mode:
        b = a * 2                             # +32 KiB
        c = b + 1                             # +32 KiB
        del b                                 # -32 KiB
        d = torch.zeros(1000)                 # +4000 B
    assert mode.live == 2 * 32768 + 4000
    assert mode.peak == 3 * 32768
    del c, d
    assert mode.live == 32768


def test_roofline_terms_math():
    t = oa.roofline_terms({"flops": 989e12, "bytes": 0.0,
                           "collective_bytes": 0.0})
    assert abs(t["t_compute"] - 1.0) < 1e-12 and t["dominant"] == "compute"
    t = oa.roofline_terms({"flops": 0.0, "bytes": 3.35e12,
                           "collective_bytes": 100e9,
                           "collective_bytes_nvlink": 0.0,
                           "collective_bytes_network": 100e9})
    # 100 GB over a 50 GB/s network link = 2 s > 1 s of HBM time
    assert abs(t["t_collective"] - 2.0) < 1e-12
    assert t["dominant"] == "collective"
    t = oa.roofline_terms({"flops": 0.0, "bytes": 3.35e12,
                           "collective_bytes": 450e9,
                           "collective_bytes_nvlink": 450e9,
                           "collective_bytes_network": 0.0})
    # 450 GB over NVLink's 450 GB/s = 1 s: tied with memory, which wins
    assert abs(t["t_collective_nvlink"] - 1.0) < 1e-12
    assert t["t_collective_network"] == 0.0
    t = oa.roofline_terms({"flops": 0.0, "bytes": 3.35e12,
                           "collective_bytes": 10e9})
    assert t["dominant"] == "memory"          # no split: network rate
    assert abs(t["t_collective"] - 0.2) < 1e-12
    assert t["step_time_lower_bound"] == max(
        t["t_compute"], t["t_memory"], t["t_collective"])
    assert (oa.PEAK_FLOPS, oa.HBM_BW, oa.NVLINK_BW, oa.NETWORK_BW) == (
        989e12, 3.35e12, 450e9, 50e9)


def test_top_contributors():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    mode = oa.OpAnalysis()
    with mode:
        for _ in range(3):
            (a @ b).relu()
    rows = oa.top_contributors(mode, 5, "flops")
    assert rows[0][1] == "aten.mm" and rows[0][2] == 3
    assert rows[0][0] == 3 * 2 * 64 ** 3


# the bounds chip_smoke.py printed for the main-path shapes in bf16 in the
# last run before the formulas moved into the package (NVIDIA H100 80GB
# HBM3, 700 W): (shape, bound_ms, bound_by)
PRINTED = {
    "flash": ((4, 512, 32, 112), 0.017606686567164177, "bytes"),
    "flash_bwd": ((4, 512, 12, 128), 0.015053717014925375, "bytes"),
    "ssd": ((4, 512, 112, 64, 1, 64), 0.022341062686567166, "bytes"),
    "ssd_bwd": ((4, 512, 112, 64, 1, 64), 0.03153579940298507, "bytes"),
    "wkv": ((4, 512, 40, 64), 0.017218483582089553, "bytes"),
    "wkv_bwd": ((4, 512, 40, 64), 0.029741850746268658, "bytes"),
}


@pytest.mark.parametrize("name", list(PRINTED))
def test_kernel_formulas_equal_the_printed_bounds(name):
    shape, bound_ms, bound_by = PRINTED[name]
    fn = {"flash": costs.flash_bound, "flash_bwd": costs.flash_bwd_bound,
          "ssd": costs.ssd_bound, "ssd_bwd": costs.ssd_bwd_bound,
          "wkv": costs.wkv_bound, "wkv_bwd": costs.wkv_bwd_bound}[name]
    b = fn(shape, 2)
    assert b["bound_ms"] == bound_ms and b["bound_by"] == bound_by
    assert costs.distance_bound((365, 3, 1024))["bound_ms"] == \
        0.0017887904477611942


def _fake_args(fake):
    with fake:
        f32 = dict(dtype=torch.float32)
        return {
            "flash": (torch.empty(2, 64, 4, 32, dtype=torch.bfloat16),) * 3,
            "ssd": (torch.empty(2, 64, 4, 16, dtype=torch.bfloat16),
                    torch.empty(2, 64, 4, **f32), torch.empty(4, **f32),
                    torch.empty(2, 64, 1, 8, dtype=torch.bfloat16),
                    torch.empty(2, 64, 1, 8, dtype=torch.bfloat16),
                    torch.empty(2, 4, 8, 16, **f32)),
            "wkv": (*(torch.empty(2, 64, 4, 16, dtype=torch.bfloat16),) * 4,
                    torch.empty(4, 16, **f32),
                    torch.empty(2, 4, 16, 16, **f32)),
        }


@pytest.mark.parametrize("name", ["flash", "ssd", "wkv"])
def test_kernel_ops_on_fake_tensors_are_one_launch_with_their_cost(name):
    """Forward and backward on fake tensors: outputs of the right shapes
    and dtypes, nothing computed, one launch each, the formulas' flops and
    bytes; the wrappers' card counts do not move."""
    fake = FakeTensorMode()
    args = _fake_args(fake)[name]
    fn = {"flash": flash_attention, "ssd": mamba2_ssd,
          "wkv": rwkv6_wkv}[name]
    before = fn.launches
    mode = oa.OpAnalysis(fake_mode=fake)
    with fake:
        leaves = [a.clone().requires_grad_(a.dtype.is_floating_point)
                  for a in args]
        with mode:
            out = fn(*leaves)
            out[0].float().sum().backward()
    assert fn.launches == before
    assert tuple(out[0].shape) == tuple(args[0].shape)
    assert out[0].dtype == args[0].dtype and out[1].dtype == torch.float32
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in leaves)
    op = name
    if name == "flash":
        fwd = costs.op_cost("flash_fwd", args)
        bwd = costs.op_cost("flash_bwd", (*args, args[0], out[1], args[0]))
    else:                            # the scans: chunk 64, no dstate_T
        fwd = costs.op_cost(f"{op}_fwd", (*args, 64))
        bwd = costs.op_cost(f"{op}_bwd", (*args, args[0], None, 64))
    assert mode.launches == {f"{op}_fwd": 1, f"{op}_bwd": 1}
    assert mode.kernel_flops == fwd["flops"] + bwd["flops"] > 0
    # FlopCounterMode reads the same formulas
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with fake, counter:
        fn(*args)
    assert counter.get_total_flops() == int(fwd["flops"])


_RINGS = """
    import json, torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.op_analysis import OpAnalysis
    with fake_process_group(4):
        mesh = Mesh(("data", "model"), (2, 2))
        mesh = mesh.with_device_mesh(init_device_mesh(
            "cpu", (2, 2), mesh_dim_names=("data", "model")))
        fake = FakeTensorMode()
        mode = OpAnalysis(mesh=mesh, fake_mode=fake)
        dm = mesh.device_mesh
        with fake:
            x = torch.empty(1024)                  # 4 KiB
            with mode:
                gather = getattr(funcol, "all_gather_single",
                                 funcol.all_gather_tensor)
                gather(x, 0, (dm, 1))
                funcol.all_reduce(x, "sum", (dm, 0))
                funcol.reduce_scatter_tensor(x, "sum", 0, (dm, 1))
                funcol.all_to_all_single(x, None, None, (dm, 0))
    print(json.dumps({k: mode.per_device()[k] for k in (
        "collective_bytes", "collective_detail",
        "collective_bytes_nvlink", "collective_bytes_network")}))
"""


def test_ring_factors_and_axes_on_a_4_rank_fake_group():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_RINGS)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    O = 4096
    expect = {"all-gather@model:2": 2 * O * (1 / 2),    # R (n-1)/n, R=2O
              "all-reduce@data:2": 2 * O * (1 / 2),     # 2 O (n-1)/n
              "reduce-scatter@model:2": O * (1 / 2),    # O (n-1)/n
              "all-to-all@data:2": O * (1 / 2)}         # O (n-1)/n
    assert out["collective_detail"] == expect
    assert out["collective_bytes"] == sum(expect.values())
    assert out["collective_bytes_nvlink"] == 1.5 * O    # the model axis
    assert out["collective_bytes_network"] == 1.5 * O   # the data axis
