"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card, and drives the port's paths:

1. the adaptive AnEn ensemble (``repro_torch.apps.anen.workflow``) at the
   NCEP NAM 12 km CONUS grid, 428 x 614 points (AWIPS grid 218), with 365
   daily historical runs, on the DAG tier: each round is one DAG carrier
   that launches ``anen_distance`` once, at (365, 3, 1024); then the same
   run on the CPU at a small size; then the multi-tenant service
   (``repro_torch.serve``) on the same dataset: 4 socket tenants, each two
   waves of 8 members x 128 locations of ``reg://analog_values``, share
   carriers that each launch ``anen_distance`` once at (365, 3, 128 x
   members); every value is held to ``compute_analogs``; then the chaos
   plane (``repro_torch.chaos``) on the same service: kernel faults with
   retries, carrier faults and a socket dropped mid-submit;
2. the seismic misfit sweep (``repro_torch.apps.seismic.workflow``), 64
   sources at the solver's own 128 x 128 grid and 400 steps: the
   forward->misfit chain alone on the chain tier, then with its sum gather
   as one DAG carrier; then a small sweep on the card against the CPU.
   This path runs no kernel of the repository;
2b. the sharded tier on lanes of the card
   (``repro_torch.device.virtual_devices``, each lane a place with its own
   CUDA stream, as the JAX package's tests run its tier on forced host
   devices): ``anen_distance_sharded`` on 2 and 4 lanes at (365, 3, 1024),
   (365, 3, 4096) and (365, 3, 510), bit-equal to ``anen_distance`` with
   one launch a lane, timed beside it; AnEn at the main path's grid and
   history with 64 members x 128 locations a round on 4 lanes (one
   ``dag-shard`` carrier a round, ``anen_distance`` once a lane at (365,
   3, 2048)), its values equal bit for bit to the same description with
   ``shard=False``; the seismic sweep as one ``dag-shard`` carrier on 4
   lanes, each lane's two links CUDA graphs: one capturing sweep, then 3
   alternating pairs of a warm sharded sweep (every link replayed) and a
   warm unsharded one, misfits bit-equal and the sum within 1e-4 of the
   unsharded run's, no refused capture, and the JAX package's CI gate
   that the sharded tier is no slower than the unsharded one (median
   unsharded wall / median warm sharded wall >= 1.0); the single-kernel
   sweep (``run_misfit_ensemble``) sharded and not, misfits bit-equal;
   and ``ef_compressed_mean`` over a data axis on the card's tensors, in
   an NCCL group of one process and a gloo group of 4 processes sharing
   the card, held to the CPU's plain mean (error bits equal, means within
   1e-6). With two or more cards it runs again over the cards, the
   compressed mean in an NCCL group of a rank a card; with one it prints
   that the distinct-card run was not made;
3. serving zamba2-7b at its published widths with random weights drawn on
   the card (``repro_torch.launch.serve.run_managed``): 2 EnTK request
   batches of 4 prompts x 512 tokens, 16 greedy new tokens each, whose
   prefill goes through ``flash_attention`` (13 launches a batch) and
   ``mamba2_ssd`` (81 launches a batch); then the smoke configuration on
   the card against the CPU with the same weights;
4. serving rwkv6-3b at its published widths the same way, with the same
   traffic, whose prefill goes through ``rwkv6_wkv`` (32 launches a
   batch); then its smoke configuration on the card against the CPU;
5. serving the attention stack's dense family the same way, with the same
   traffic: stablelm-12b (``flash_attention`` 40 launches a batch at head
   dim 160), minitron-4b (32 at head dim 128) and chatglm3-6b (28 at
   (4, 512, 32, 128)), each with its smoke configuration on the card
   against the CPU. On every serve path (3-7) each prefill and decode
   step runs its norms as fused ``rms_norm`` launches, counted exactly
   (``norm_launches_per_prefill``: 2 a layer and the final norm on the
   attention stack, 57 a chatglm3-6b batch), none on the plain chain
   (but RWKV's float32 second norm); the kernel itself is held to the
   plain chain (h equal bits, y within one bf16 ulp, no spill) and timed
   beside it (``check_norm``);
6. the vlm and audio families at their published widths through the step
   functions on precomputed bf16 embeddings, as the JAX package runs them
   (its serve driver takes token ids only): qwen2-vl-2b with (B, 3, S)
   M-RoPE positions (28 flash launches) and musicgen-medium (48), each one
   prefill of 4 x 512 embeddings and 15 decode steps; then its smoke
   configuration's prefill on the card against the CPU;
7. serving the MoE family at its published widths with the same traffic
   as 3-5, its depth cut to fit the card: dbrx-132b with 10 of 40 layers
   (33.8e9 parameters, 67.6 GB in bf16; ``flash_attention`` 10 launches a
   batch at (4, 512, 48, 128)) and llama4-maverick-400b-a17b with two
   groups of a dense and an MoE layer (35.0e9, 70.1 GB; 4 at (4, 512, 40,
   128)); prefill's and decode's device time split by the MoE layer's
   profiler ranges (route, dispatch, experts, combine, shared expert) and
   the rest; each with its smoke configuration on the card against the
   CPU, in bf16 with the card's routes pinned to the CPU's and in f32
   with the chosen experts compared;
8. training (``repro_torch.launch.train``), f32 masters and AdamW state,
   3 steps of 4 x 512 on the synthetic stream for each of: qwen2-vl-2b at
   its published width and depth, each step launching the flash forward
   56 times (28 layers, each recomputed once under remat) and its
   backward kernel (``flash_attention_bwd``) 28 times at (4, 512, 12,
   128); rwkv6-3b at its published width and depth (``rwkv6_wkv`` 64 and
   ``rwkv6_wkv_bwd`` 32 times a step at (4, 512, 40, 64), every backward
   on its wgmma route); zamba2-7b at
   its published width with its depth cut to 45 of 81 layers (7 groups of
   6 Mamba-2 layers and the shared block, then 3: ``mamba2_ssd`` 90 and
   ``mamba2_ssd_bwd`` 45 times a step at (4, 512, 112, 64, 1, 64), each
   on the cluster route, flash 14 and 7 at (4, 512, 32, 112)), each with
   a profile of one more step;
   then one train step of the stablelm-12b, qwen2-vl-2b, zamba2-7b,
   rwkv6-3b, dbrx-132b and llama4-maverick smoke configurations on the
   card against the CPU; then
   minitron-4b's smoke configuration through ``run_managed`` on
   ``TorchRTS``, 20 steps in chunks of 5 with one injected fault (one
   retry, no step trained twice).
9. The dry-run tier (``repro_torch.launch.dryrun`` on a one-device mesh:
   fake tensors on the card's device type) predicts qwen2-vl-2b's full
   train step and minitron-4b's prefill at (4, 512); each step then runs
   for real, and the prediction must meet its ``max_memory_allocated``
   within 15 %, its kernel launches exactly and its matmul FLOPs
   (``FlopCounterMode``) within 1e-6. Then int8 gradient compression on
   the card gives the CPU's bits, and minitron-4b's smoke
   ``TrainSession(grad_compression="int8")`` allocates its zero f32
   error state on the card and trains the losses of an uncompressed one.

Before the serve paths it checks that the CUDA routes of the flash, SSD
and WKV kernels take grads (``autograd.grad`` through each forward and
backward kernel pair against autograd through the plain forward), holds
each backward kernel against its plain version (flash, SSD and WKV: bf16
on the tensor cores, f32 on the CUDA cores; flash's f32 route within the
first port's 1e-5, the SSD's and WKV's f32 errors within 1e-5 of the
first port's; SSD and WKV at the train shapes and ragged and small ones,
with a nonzero final-state gradient and, for WKV, at the clamps; each
with equal bits on a second call), times flash's three kernels apart,
the SSD's and WKV's bf16 kernels apart, and each backward kernel at its
train shape, and prints every compiled kernel's registers, shared memory
and blocks an SM (for flash, SSD and WKV each route: f32 on the CUDA
cores, bf16 on the tensor cores; the bf16 flash backward's two kernels
at head dims 112, 128 and 160, failing on a spill at 128; the SSD and
WKV backward kernels at their train shapes, failing on a spill), and the
device time of an empty kernel, the floor under every kernel time it
prints.

The bf16 flash forward takes the wgmma kernel (TMA ring, a producer warp,
two consumer warpgroups) at every main-path head dim: each compare names
the route its inputs took, a second call must give equal bits in both
modes, and the compiled forward at head dims 64, 112, 128 and 160 must be
the 384-thread wgmma kernel with no spill; views a TMA tensor map cannot
describe (2 bytes past a 16-byte boundary) and hd 150 must take the
mma.sync kernel and meet the same gates; it is timed in both modes at the
seven attention-stack shapes beside SDPA. The bf16 flash backward takes
its wgmma kernels (dk/dv and dq: TMA ring, a producer warp, two consumer
warpgroups) wherever the inputs are aligned bf16 with hd % 8 == 0 at the
padded head dims 32, 64, 112 and 128: each backward compare names its
route and must take the one its shape calls for, the compiled dk/dv and
dq kernels at head dims 32, 64, 112 and 128 in both modes must be the
384-thread wgmma kernels with no spill, and the unaligned views, hd 150
and hd 160 must take the mma.sync kernels and meet the same gates. The
bf16 SSD backward takes its cluster kernel (a thread block cluster over
the chunks, the chunk states passed through distributed shared memory,
wgmma) at N = P = chunk = 64 with one B/C group and at most 8 chunks:
each SSD backward compare names its route and the train shape must take
the cluster route, the cluster kernel must spill nothing and a cluster of
the train shape's 8 chunks must fit the card; its busy time is read by
kernel (the cluster kernel and the sums), and the workspace traffic it
prints is the head groups' partial dB and dC. The bf16 SSD forward at N
= P = chunk = 64 (any number of B/C groups, any T) takes Hopper's TMA and
wgmma, one warpgroup a (b, h) walking the chunks. Each forward compare
names its route and must take the one ``SSD_FWD_ROUTES`` gives its shape,
a second bf16 call must give equal bits, the warpgroup kernel must spill
nothing and fit 4 blocks an SM (so that zamba2's 448 (b, h) run in one
wave), and every SSD forward of zamba2-7b's serve path and
zamba2-7b-45l's train step must take the warpgroup route
(``mamba2_ssd.routes``). The bf16 WKV forward at N = chunk = 64 (any T a
multiple of 64) takes Hopper's TMA and wgmma, three warpgroups a (b, h):
the elementwise pass on two, a chunk ahead of the products on the third.
Each WKV forward compare names its route and must take the one
``WKV_FWD_ROUTES`` gives its shape (the main shape, one batch row of its
heads and two chunks on wgmma; chunk 50, chunk 1 and N below 64 on
mma.sync), a second bf16 call must give equal bits, the wgmma route is
also held with the decay drawn to reach both clamps (``WKV_CLAMPED``), its
kernel must spill nothing and fit 2 blocks an SM, and every WKV forward of
rwkv6-3b's serve path and train step must take the wgmma route
(``rwkv6_wkv.routes``; all of them, 256, summed over the paths). The bf16
WKV backward takes its own wgmma route on the same shapes: one block of
three warpgroups a (b, h) walks the chunks forwards for their start states
(bf16 hi + lo tiles to a workspace), then backwards with the state's
gradient in registers. Each WKV backward compare names its route and
must take the one its shape calls for, the route is held at the main
shape, one batch row of its heads and the clamped draw, with and without
a final-state gradient (``WKV_BWD_WGMMA``), with equal bits on a second
call, its kernel must spill nothing, and every WKV backward of rwkv6-3b's
train step must take it (``rwkv6_wkv_bwd.routes``); its busy time is read
by kernel (the wgmma kernel and du's sum) and the workspace traffic it
prints is the chunk states' tiles, written once and read once.

Flash attention's non-causal mode (``flash_attention(causal=False)``,
bidirectional attention, the JAX kernel's ``causal=False``) is held the
same way: its forward kernels (both routes) at the attention stack's
shapes at S = 512, a ragged S = 300, S = 1 and hd 150, its backward
kernels in bf16 at (4, 512, 12, 128) and (4, 512, 32, 112) and in f32 at
small shapes, each within the causal mode's tolerances with equal bits on
a second call, no spill in the bf16 kernels at hd 112, 128 and 160, timed
beside ``scaled_dot_product_attention(is_causal=False)`` and its backward;
then driven through its entry point under grad (a forward and a backward
launch at each of two shapes, counted apart from the causal launches).

Each path runs with the launch counts set to 0 just before it and read
just after, and fails unless every kernel of the path launched. Every
phase raises on failure, so a failed phase exits non-zero and prints no
result. Without CUDA, or without the rest of the repository beside it, it
fails.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# every CUDA source of the port (src/repro_torch/kernels/csrc/<name>.cu)
KERNEL_SOURCES = ("anen_distance", "flash_attention", "flash_attention_bwd",
                  "mamba2_ssd", "mamba2_ssd_bwd", "rwkv6_wkv",
                  "rwkv6_wkv_bwd", "rms_norm")


def _load_costs():
    """This tree's ``repro_torch/kernels/costs.py`` (the kernels' bounds
    and the published peaks of one H100 SXM, NVIDIA data sheet, 700 W:
    one definition, shared with the dry-run), loaded by its path, so that
    a tool that puts another tree's ``src`` first still reads these."""
    import importlib.util
    path = os.path.join(SRC, "repro_torch", "kernels", "costs.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke_costs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_costs = _load_costs()
HBM_BYTES_PER_S = _costs.HBM_BYTES_PER_S
FP32_FLOPS_PER_S = _costs.FP32_FLOPS_PER_S
BF16_FLOPS_PER_S = _costs.BF16_FLOPS_PER_S
distance_bound = _costs.distance_bound
flash_bound, flash_bwd_bound = _costs.flash_bound, _costs.flash_bwd_bound
ssd_bound, ssd_bwd_bound = _costs.ssd_bound, _costs.ssd_bwd_bound
wkv_bound, wkv_bwd_bound = _costs.wkv_bound, _costs.wkv_bwd_bound
norm_bound = _costs.norm_bound

MAIN = dict(seed=0, ny=428, nx=614, n_hist=365, per_iter=1024, max_iters=4,
            n_tasks=8, slots=4, timeout=900.0)
# one DAG carrier a round: the 8 members' 128 locations each in one launch
ANEN_MAIN_SHAPE = (MAIN["n_hist"], 3, MAIN["per_iter"])
# the seismic sweep: 64 sources at SeismicConfig's own grid and length
SEISMIC = dict(n_events=64, nx=128, nt=400, seed=0, dv=25.0, slots=4)
SEISMIC_SMALL = dict(n_events=8, nx=32, nt=60, seed=0, dv=25.0, slots=4)
# dispatches of the forward->misfit->sum DAG: one composed segment, as
# tests/test_torch_seismic.py pins against the JAX package's RTS
SEISMIC_DAG_DISPATCHES = 1
# the sharded phase's warm (sharded, unsharded) seismic sweeps, in turns
SEISMIC_WARM_PAIRS = 3
SMALL = dict(seed=3, ny=20, nx=20, n_hist=30, per_iter=16, max_iters=2,
             n_tasks=4, slots=4, timeout=120.0)
# N % 4 != 0 (scalar loads), fewer than 4 columns, and the timed shapes
EQUAL_SHAPES = ((60, 3, 37), (9, 2, 130), (365, 3, 510), (7, 3, 3),
                (5, 1, 1), (365, 3, 1024), (365, 3, 4096))
TIMED_SHAPES = ((365, 3, 1024), (365, 3, 4096))
# the multi-tenant service: socket tenants, each two waves of 8 members x
# 128 locations of reg://analog_values, drawn from the tenant's own quadrant
# of the main path's dataset, on 4 slots behind the JAX package's default
# 0.25 s batching window
SERVICE = dict(tenants=4, waves=2, members=8, locs=128, slots=4,
               hold_s=0.25, k=12)
# the chaos sub-phase's kernel faults (rate 0.1)
CHAOS_KERNEL_SEED = 23
TIMED_REPS = 60
# the sharded tier on lanes of the card (repro_torch.device.virtual_devices,
# the counterpart of the JAX package's forced host devices): B2 on 2 and 4
# lanes at the main path's shapes and a ragged N, 365 % 4 != 0 padding H
SHARD_LANES = (2, 4)
SHARD_SHAPES = ((365, 3, 1024), (365, 3, 4096), (365, 3, 510))
# AnEn at the main path's grid and history, 64 members x 128 locations a
# round (JaxRTS's default shard_min_members), on 4 lanes and 4 slots:
# plan_mesh gives one dispatch of 16 members a lane (DEFAULT_MAX_BATCH
# 4096), so the distance runs once a lane at (365, 3, 16 x 128)
SHARDED_ANEN = dict(MAIN, per_iter=8192, n_tasks=64, max_iters=2)
SHARDED_LANES = 4
SHARDED_ANEN_SHAPE = (MAIN["n_hist"], 3, 2048)

# the serve paths: zamba2-7b, rwkv6-3b, stablelm-12b and minitron-4b at
# full width with the same traffic, and the kernels' shapes on them
SERVE = dict(arch="zamba2-7b", n_batches=2, batch_size=4, prompt_len=512,
             max_new_tokens=16)
RWKV_SERVE = dict(SERVE, arch="rwkv6-3b")
# the attention stack: two dense configurations served with the same
# traffic, then the vlm and audio ones on embeddings through the steps
DENSE_SERVES = (dict(SERVE, arch="stablelm-12b"),
                dict(SERVE, arch="minitron-4b"),
                dict(SERVE, arch="chatglm3-6b"))
EMBED_RUNS = (dict(arch="qwen2-vl-2b", batch_size=4, prompt_len=512,
                   decode_steps=15),
              dict(arch="musicgen-medium", batch_size=4, prompt_len=512,
                   decode_steps=15))
FLASH_MAIN = (4, 512, 32, 112)            # (B, S, H, hd)
SSD_MAIN = (4, 512, 112, 64, 1, 64)       # (B, T, H, P, G, N)
WKV_MAIN = (4, 512, 40, 64)               # (B, T, H, N)
FLASH_STABLELM = (4, 512, 32, 160)
FLASH_MINITRON = (4, 512, 24, 128)
FLASH_CHATGLM = (4, 512, 32, 128)
FLASH_QWEN2_VL = (4, 512, 12, 128)
FLASH_MUSICGEN = (4, 512, 24, 64)
FLASH_MANAGED_TRAIN = (8, 128, 4, 32)     # minitron-4b smoke, run_managed
FLASH_DBRX = (4, 512, 48, 128)
FLASH_LLAMA4 = (4, 512, 40, 128)
# the MoE family served at its published widths with the depth cut to fit
# the card's 80 GB (weights in bf16, about 1 GB of activations beside
# them): dbrx-132b with 10 of its 40 layers (67.6 GB), llama4-maverick
# with two groups of 2 (a dense layer and an MoE layer of all 128 experts
# and the shared expert; 70.1 GB); a third group would take 103 GB
MOE_CUTS = (dict(name="dbrx-132b-10l", base="dbrx-132b", n_layers=10,
                 params=33_823_979_520),
            dict(name="llama4-maverick-400b-a17b-4l",
                 base="llama4-maverick-400b-a17b", n_layers=4,
                 params=35_037_557_760))
MOE_SERVES = tuple(dict(SERVE, arch=cut["name"]) for cut in MOE_CUTS)
MAIN_SHAPES = {"zamba2-7b": {"flash_attention": FLASH_MAIN,
                             "mamba2_ssd": SSD_MAIN},
               "rwkv6-3b": {"rwkv6_wkv": WKV_MAIN},
               "stablelm-12b": {"flash_attention": FLASH_STABLELM},
               "minitron-4b": {"flash_attention": FLASH_MINITRON},
               "chatglm3-6b": {"flash_attention": FLASH_CHATGLM},
               "qwen2-vl-2b": {"flash_attention": FLASH_QWEN2_VL},
               "musicgen-medium": {"flash_attention": FLASH_MUSICGEN},
               "dbrx-132b-10l": {"flash_attention": FLASH_DBRX},
               "llama4-maverick-400b-a17b-4l": {
                   "flash_attention": FLASH_LLAMA4}}
FLASH_SHAPES = (FLASH_MAIN, (4, 100, 32, 112), (4, 300, 32, 112),
                # hd 32 and the tile edges S = 1, 63, 65
                (1, 1, 2, 32), (2, 63, 3, 32), (2, 65, 3, 32),
                # the attention stack's shapes, then ragged S at hd 160 and
                # at 150 (not a multiple of 8: element-wise tile fills)
                FLASH_STABLELM, FLASH_MINITRON, FLASH_QWEN2_VL,
                FLASH_MUSICGEN, (4, 100, 32, 160), (2, 65, 3, 160),
                (4, 100, 32, 150), (2, 65, 3, 150),
                # the managed train run's shape (phase 8), the MoE serve
                # shapes (phase 7)
                FLASH_MANAGED_TRAIN, FLASH_DBRX, FLASH_LLAMA4)
# timed beside FLASH_MAIN: the widest head dim, minitron's, the MoE serve
# shapes, qwen2-vl-2b's train shape and musicgen-medium's head dim 64
FLASH_TIMED = (FLASH_STABLELM, FLASH_MINITRON, FLASH_DBRX, FLASH_LLAMA4,
               FLASH_QWEN2_VL, FLASH_MUSICGEN)
# the SSD forward's shapes with the route each takes in bf16
# (mamba2_ssd.fwd_route): at N = P = chunk = 64 the warpgroup kernel (the
# serve shape; G = 2; 3 chunks; 9 chunks at G = 2); mma.sync for chunk 50
# and for N, P below 64 (chunk 50 at N = 8, P = 16; G = 2 at N = 16, P =
# 32)
SSD_FWD_ROUTES = {SSD_MAIN: "warpgroup", (4, 100, 112, 64, 1, 64): "mma.sync",
                  (2, 128, 8, 64, 2, 64): "warpgroup",
                  (1, 100, 3, 16, 1, 8): "mma.sync",
                  (2, 128, 4, 32, 2, 16): "mma.sync",
                  (2, 192, 8, 64, 1, 64): "warpgroup",
                  (1, 576, 8, 64, 2, 64): "warpgroup"}
SSD_SHAPES = tuple(SSD_FWD_ROUTES)
# the WKV forward's shapes with the route each takes in bf16
# (rwkv6_wkv.fwd_route): at N = chunk = 64 the wgmma kernel (the serve
# shape, one batch row of its heads, two chunks); mma.sync for a ragged T
# (chunk 50), a prime T (chunk 1) and the padding of N = 16, 24
# (element-wise tile fills), 32 and 5, at chunks 50 and 1
WKV_FWD_ROUTES = {WKV_MAIN: "wgmma", (1, 512, 40, 64): "wgmma",
                  (2, 128, 3, 64): "wgmma", (4, 100, 40, 64): "mma",
                  (1, 97, 2, 64): "mma", (2, 100, 3, 16): "mma",
                  (1, 97, 2, 16): "mma", (2, 100, 3, 24): "mma",
                  (1, 97, 2, 24): "mma", (2, 100, 4, 32): "mma",
                  (1, 100, 2, 5): "mma"}
WKV_SHAPES = tuple(WKV_FWD_ROUTES)
# the wgmma route with the decay drawn to reach both clamps
WKV_CLAMPED = ((2, 128, 3, 64),)
# the JAX kernel tests' tolerances (tests/test_kernels.py), atol = rtol;
# the WKV state's is 10x its output's
TOLERANCE = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
             "mamba2_ssd": {"float32": 1e-4, "bfloat16": 6e-2},
             "rwkv6_wkv": {"float32": 1e-4, "bfloat16": 5e-2}}
# the JAX package's kernel-vs-reference model tolerance
MODEL_ATOL, MODEL_RTOL = 0.08, 0.05
# the MoE smoke configurations card against CPU in f32 (atol = rtol), as
# tests/test_torch_gpu.py holds them
MOE_F32_TOL = 1e-3

# phase 8, training: the flash backward's shapes (the zamba2 shape, the
# qwen2-vl training shape, the managed run's, hd 160 and 150, and GQA-free
# ragged S at the 64-row tiles' edges), its tolerances, the full-width
# train run, the smoke configurations held card against CPU, and the
# managed run
FLASH_BWD_SHAPES = (FLASH_MAIN, FLASH_QWEN2_VL, FLASH_MANAGED_TRAIN,
                    (4, 100, 32, 160), (2, 65, 3, 160), (4, 100, 32, 150),
                    (2, 65, 3, 150), (1, 1, 2, 32), (2, 63, 3, 32),
                    (2, 65, 3, 32), (2, 100, 3, 64))
FLASH_BWD_TIMED = (FLASH_QWEN2_VL, FLASH_MAIN)
# flash attention without the causal mask (causal=False): the forward at
# the attention stack's shapes, a ragged S, S = 1 and hd 150 (both
# routes); the backward in bf16 at the train shapes and a ragged one, in
# f32 at small shapes; the timed shapes (bf16) and the head dims whose
# bf16 kernels must not spill
FLASH_FULL_SHAPES = (FLASH_MAIN, FLASH_MINITRON, FLASH_STABLELM,
                     (4, 300, 32, 112), (2, 1, 3, 32), (2, 65, 3, 150))
FLASH_FULL_BWD_SHAPES = {"bfloat16": (FLASH_QWEN2_VL, FLASH_MAIN,
                                      (2, 100, 3, 64), (1, 300, 2, 160)),
                         "float32": ((2, 100, 3, 64), (2, 65, 3, 160))}
FLASH_FULL_TIMED = (FLASH_MAIN, FLASH_MINITRON, FLASH_STABLELM, FLASH_DBRX,
                    FLASH_LLAMA4, FLASH_QWEN2_VL, FLASH_MUSICGEN)
FLASH_FULL_BWD_TIMED = (FLASH_QWEN2_VL, FLASH_MAIN)
FLASH_FULL_INFO_HDS = (112, 128, 160)
# a bf16 input TMA cannot describe (its views start 2 bytes past a 16-byte
# boundary): it must take the mma.sync kernel
FLASH_UNALIGNED = (2, 100, 3, 112)
# the bf16 forward's head dims on the main paths: each must take the wgmma
# kernel (384 threads) and spill nothing, in both modes
FLASH_FWD_INFO_HDS = (64, 112, 128, 160)
# the bf16 backward's head dims on the train paths (128 qwen2-vl-2b, 112
# zamba2-7b-45l, 32 the managed minitron-4b smoke) and 64: its dk/dv and
# dq kernels must be the wgmma ones (384 threads) and spill nothing, in
# both modes
FLASH_BWD_WGMMA_HDS = (32, 64, 112, 128)
# f32: the JAX gradient tolerance (tests/test_kernels.py:56). bf16: both
# sides sum in f32 and round dq, dk, dv once to bf16; sums in another
# order can round to neighbouring bf16 values, 2^-8 of |ref| apart, so
# 1e-2 (atol = rtol) covers one such step with room. The bf16 kernels
# also round P and dS to bf16 as tensor-core operands; on the CPU
# (tests/test_torch_tensor_core_rounding.py) that rounding stays within
# the same 1e-2 of the plain version
BWD_TOLERANCE = {"float32": 5e-4, "bfloat16": 1e-2}
# the f32 route's (CUDA cores) largest error against the plain version
# in the first port (1.0e-5 at (4, 512, 32, 112)): it stays that route
BWD_F32_UNCHANGED = 1e-5
# head dims of the bf16 backward kernels whose registers are printed; a
# spill at the train shape's (128) fails the run
BWD_INFO_HDS = (112, 128, 160)
# the SSD and WKV backward kernels: the train shapes, a ragged T (chunk
# 50), G = 2 (also at T = 100) and N != P and N = 5 (SSD), chunk 1 and N =
# 5 and 32 (WKV), each with a nonzero state0 and final-state gradient; WKV
# also with channels whose cumsum passes -30 and steps with w < 1e-8
# ("clamped")
SSD_BWD_SHAPES = (SSD_MAIN, (4, 100, 112, 64, 1, 64), (2, 128, 8, 64, 2, 64),
                  (1, 100, 3, 16, 1, 8), (2, 128, 4, 32, 2, 16),
                  (2, 100, 8, 64, 2, 64), (1, 100, 3, 16, 1, 5))
WKV_BWD_SHAPES = (WKV_MAIN, (4, 100, 40, 64), (1, 97, 2, 64), (2, 100, 3, 16),
                  (1, 100, 2, 5), (2, 100, 4, 32))
WKV_BWD_CLAMPED = ((2, 128, 3, 64),)
# the shapes whose bf16 backward takes the WKV wgmma route (N = chunk = 64),
# besides the clamped one: the train shape and one batch row of its heads,
# each held also without a final-state gradient (as the train step calls
# it)
WKV_BWD_WGMMA = (WKV_MAIN, (1, 512, 40, 64))
# The f32 routes of the SSD and WKV backward stay the CUDA-core scans of
# commit ff86033: the digest (scan_bwd_digest) of their gradients on these
# inputs, shape by shape, as that commit's kernels give them
# (tools/scan_bwd_digest.py --src on that commit's src; NVIDIA H100 80GB
# HBM3, 700.00 W, nvcc 12.9). The route is deterministic and independent of
# the plain version, so a run must give the same bits: no gradient moves
# at all, let alone by BWD_F32_UNCHANGED. (Another nvcc may round one
# differently: then take the digests again from that commit.)
SCAN_BWD_F32_DIGEST = {
    ("mamba2_ssd", SSD_MAIN, False): "9bf70f372e946b64",
    ("mamba2_ssd", (4, 100, 112, 64, 1, 64), False): "11c8c2028ee674aa",
    ("mamba2_ssd", (2, 128, 8, 64, 2, 64), False): "c7e1f5ca6dfb44d6",
    ("mamba2_ssd", (1, 100, 3, 16, 1, 8), False): "a5b251034fec3894",
    ("mamba2_ssd", (2, 128, 4, 32, 2, 16), False): "31a371aa61c54267",
    ("mamba2_ssd", (2, 100, 8, 64, 2, 64), False): "a25ab6671887eddc",
    ("mamba2_ssd", (1, 100, 3, 16, 1, 5), False): "a58d2db8e09843d1",
    ("rwkv6_wkv", WKV_MAIN, False): "c96227d259a20175",
    ("rwkv6_wkv", (4, 100, 40, 64), False): "664ab01d13f6a1d6",
    ("rwkv6_wkv", (1, 97, 2, 64), False): "09084e558f26e48d",
    ("rwkv6_wkv", (2, 100, 3, 16), False): "8103c751199b779d",
    ("rwkv6_wkv", (1, 100, 2, 5), False): "e6c149facaa6b132",
    ("rwkv6_wkv", (2, 100, 4, 32), False): "f943119e770f7fb3",
    ("rwkv6_wkv", (2, 128, 3, 64), True): "12edd9cdd1a892c7"}
SCAN_GRADS = {"mamba2_ssd": ("dx", "ddt", "dA", "dBm", "dCm", "dstate0"),
              "rwkv6_wkv": ("dr", "dk", "dv", "dw", "du", "dstate0")}
# phase 8's full-width train runs, 3 steps of 4 x 512 each: qwen2-vl-2b,
# rwkv6-3b at full width and depth, and zamba2-7b at full width with its
# depth cut to 45 of 81 layers (7 groups of 6 Mamba-2 layers, each followed
# by the shared block, then 3 trailing layers: the published 13 x 6 + 3
# structure; 81 layers need 108 GB of f32 state and gradients, 45 about 63)
ZAMBA_CUT = dict(name="zamba2-7b-45l", base="zamba2-7b", n_layers=45)
TRAIN_RUNS = (dict(arch="qwen2-vl-2b", seq_len=512, global_batch=4, steps=3),
              dict(arch="rwkv6-3b", seq_len=512, global_batch=4, steps=3),
              dict(arch=ZAMBA_CUT["name"], seq_len=512, global_batch=4,
                   steps=3))
TRAIN_SHAPES = {
    "qwen2-vl-2b": {"flash_attention": FLASH_QWEN2_VL,
                    "flash_attention_bwd": FLASH_QWEN2_VL},
    "rwkv6-3b": {"rwkv6_wkv": WKV_MAIN, "rwkv6_wkv_bwd": WKV_MAIN},
    ZAMBA_CUT["name"]: {"mamba2_ssd": SSD_MAIN, "mamba2_ssd_bwd": SSD_MAIN,
                        "flash_attention": FLASH_MAIN,
                        "flash_attention_bwd": FLASH_MAIN}}
TRAIN_SMOKE = ("stablelm-12b", "qwen2-vl-2b", "zamba2-7b", "rwkv6-3b",
               "dbrx-132b", "llama4-maverick-400b-a17b")
TRAIN_MANAGED = dict(arch="minitron-4b", total_steps=20, steps_per_chunk=5,
                     fail_once_at=5)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    """One nvcc per source, all started together; then load them."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.kernels._build",
                               name], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for name in KERNEL_SOURCES]
    for name, proc in zip(KERNEL_SOURCES, procs):
        out, err = proc.communicate()
        check(proc.returncode == 0, f"build of {name}.cu: {err}")
        print(f"built {name}: {out.strip()}\n{err.strip()}")
    from repro_torch.kernels import (anen_distance, flash_attention,
                                     mamba2_ssd, rms_norm, rwkv6_wkv)
    for kmod in (anen_distance, flash_attention, mamba2_ssd, rwkv6_wkv,
                 rms_norm):
        kmod.build()     # the scans' build() loads their backward too
    return time.perf_counter() - t0


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def device_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median device time of one call that launches one kernel: ``reps``
    calls queued back to back behind a spin kernel, with a CUDA event
    between consecutive calls, so the host's enqueue cost never shows as
    device time. The spin grows until it outlasts the enqueue (the first
    event must still be pending when the host has queued everything). A
    function of many launches can fill the launch queue, so the host waits
    on the spin whatever its length: that raises rather than spins on
    (time it with :func:`busy_ms`)."""
    import torch
    for _ in range(5):
        fn()
    cycles = 1 << 24
    while True:
        check(cycles <= 1 << 32, "device_ms: the spin never outlasted the "
                                 "enqueue (too many launches a call)")
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(reps + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        for i in range(reps):
            events[i].record()
            fn()
        events[reps].record()
        covered = not events[0].query()
        events[reps].synchronize()
        if covered:
            return _median([events[i].elapsed_time(events[i + 1])
                            for i in range(reps)])
        cycles *= 4


#: the profiler's misses: how many traces came back with no device time
#: (each taken again), and which busy times were timed by CUDA events
#: instead because every trace of them came back empty
PROFILER_MISSES = {"empty_traces": 0, "timed_by_events": []}
TRACE_TRIES = 6


def busy_ms(fn, what: str = "", reps: int = 10) -> float:
    """Device busy time of one call of a function that launches many
    kernels (a plain version, a library call): the CUPTI device time of
    every kernel and copy of ``reps`` calls under ``torch.profiler``,
    over ``reps``. Gaps while the device waits for the host do not
    count. Where every trace comes back empty, the time from CUDA events
    around the ``reps`` calls instead (:func:`events_ms`, gaps included),
    noted in ``PROFILER_MISSES``."""
    rows = traced_rows(fn, reps)
    if rows:
        return sum(r[2] for r in rows) / reps
    PROFILER_MISSES["timed_by_events"].append(what or repr(fn))
    return events_ms(fn, reps)


def events_ms(fn, reps: int = 10) -> float:
    """Device time of one call from CUDA events around ``reps`` calls
    queued back to back on an idle device, over ``reps``: the busy time
    plus any gaps in which the device waited for the host."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def traced_rows(fn, reps: int = 10) -> list:
    """``device_rows`` of one trace of ``reps`` calls of ``fn``, or [] when
    ``TRACE_TRIES`` traces all came back with no device time. The
    profiler now and then hands a trace back empty, several in a row at
    times: each try after the first waits a little longer first, and
    every other one traces the host's activity too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for attempt in range(TRACE_TRIES):
        if attempt:
            PROFILER_MISSES["empty_traces"] += 1
            time.sleep(0.5 * attempt)
        activities = ([ProfilerActivity.CUDA] if attempt % 2 == 0 else
                      [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if sum(r[2] for r in rows) > 0:
            return rows
    PROFILER_MISSES["empty_traces"] += 1
    print(f"the profiler saw no device time in {TRACE_TRIES} traces of "
          f"{fn!r}")
    return []


def call_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median time of one call as a caller sees it: CUDA events around a
    single call on an idle device, so the wrapper's host cost counts."""
    import torch
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return _median(times)


def distance_inputs(shape, seed: int = 7):
    import numpy as np
    import torch
    h, v, n = shape
    rng = np.random.default_rng(seed)
    fh = torch.from_numpy(rng.standard_normal((h, v, n)).astype(np.float32))
    fn = torch.from_numpy(rng.standard_normal((v, n)).astype(np.float32))
    return fh.cuda(), fn.cuda()



def compare_distance(shape) -> dict:
    """Kernel vs plain version on the card, on the same inputs: they must
    be bit-equal (tolerance 0: same operation order, no FMA)."""
    import torch
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_plain)
    fh, fn = distance_inputs(shape)
    got = anen_distance(fh, fn)
    ref = anen_distance_plain(fh, fn)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err == 0.0, f"anen_distance bit-equal to plain at {shape} "
                      f"(max abs err {err})")
    return {"shape": list(shape), "max_abs_err": err}


def empty_ms() -> float:
    """Device time of an empty kernel (``torch.cuda._sleep`` of one
    cycle) by :func:`device_ms`: the floor under every kernel time."""
    import torch
    return device_ms(lambda: torch.cuda._sleep(1))


def time_distance(shape) -> dict:
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_plain)
    fh, fn = distance_inputs(shape)
    kernel = lambda: anen_distance(fh, fn)            # noqa: E731
    plain = lambda: anen_distance_plain(fh, fn)       # noqa: E731
    row = {"shape": list(shape),
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel), "plain_call_ms": call_ms(plain)}
    row.update(distance_bound(shape))
    return row


def reset_counts() -> None:
    """Every kernel wrapper's launch count (and shape count) to 0."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_sharded)
    for fn in (anen_distance, anen_distance_sharded, *KERNELS.values()):
        fn.launches = 0
        fn.shapes.clear()
        if hasattr(fn, "noncausal_launches"):
            fn.noncausal_launches = 0
        if hasattr(fn, "routes"):
            fn.routes.clear()


def run_main_path() -> dict:
    import torch
    from repro_torch.apps.anen import workflow as wf
    from repro_torch.kernels.anen_distance import anen_distance
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runs = {}
    for method in ("run_adaptive", "run_random"):
        before = anen_distance.launches
        t0 = time.perf_counter()
        res = getattr(wf, method)(device="cuda", **MAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = res["fusion_stats"]
        launched = anen_distance.launches - before
        rounds = res["rounds"]
        print(f"{method}: all_done={res['all_done']} rounds={rounds} "
              f"locations={res['n_locations']} wall_s={wall}")
        print(f"  errors per round: {res['errors']}")
        print(f"  round wall seconds: {res['round_seconds']}")
        print(f"  fusion_stats: {stats}")
        print(f"  dispatches a round: {stats['dispatches'] / max(1, rounds)}")
        print(f"  anen_distance launches: {launched}")
        check(res["all_done"], f"{method} all_done")
        check(rounds == MAIN["max_iters"], f"{method} rounds")
        check(all(math.isfinite(e) for e in res["errors"]),
              f"{method} finite errors")
        check(stats["dag_carriers"] == rounds,
              f"{method}: one DAG carrier a round ({stats['dag_carriers']})")
        check(stats["fused"] > 0, f"{method} fused > 0")
        check(stats["scalar_fallback"] == 0, f"{method} scalar_fallback == 0")
        check(stats["degraded"] == 0, f"{method} degraded == 0")
        check(launched == rounds,
              f"{method}: one anen_distance launch a round (got {launched})")
        runs[method] = {"wall_s": wall, "errors": res["errors"],
                        "round_seconds": res["round_seconds"],
                        "fusion_stats": stats}
    launches = anen_distance.launches
    shapes = dict(anen_distance.shapes)
    key = (MAIN["seed"], MAIN["ny"], MAIN["nx"], MAIN["n_hist"], "cuda:0")
    print(f"dataset build and upload seconds: {wf.DATASET_SECONDS.get(key)}")
    print(f"max_memory_allocated bytes: {torch.cuda.max_memory_allocated()}")
    print(f"main path anen_distance launches: {launches}, shapes: "
          f"{ {str(k): v for k, v in shapes.items()} }")
    check(set(shapes) == {ANEN_MAIN_SHAPE},
          f"anen_distance ran at {ANEN_MAIN_SHAPE} only")
    return {"launches": launches, "shapes": shapes, "runs": runs}


def device_rows(prof) -> list:
    """(name, count, device ms) of every kernel, copy and set that the
    profiler saw on the device, largest first. CPU-side ops are left out
    (their device time repeats their kernels'), and so are the "Command
    Buffer Full" wait, which is host time, and the device-side spans of
    the MoE layer's profiler ranges, which repeat their kernels'."""
    from torch.autograd import DeviceType
    from repro_torch.models.moe import RANGES
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and e.key != "Command Buffer Full" and e.key not in RANGES]
    rows.sort(key=lambda r: -r[2])
    return rows


def profile_main_path() -> None:
    """One more adaptive run of the main path under ``torch.profiler``:
    device time by kernel and the device's busy share of the wall time
    (profiler overhead included). Its launches are not counted: the
    main path's counts were read before."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.apps.anen.workflow import run_adaptive
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_adaptive(device="cuda", **MAIN)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(res["all_done"], "profiled run all_done")
    rows = device_rows(prof)
    busy_ms = sum(r[2] for r in rows)
    print(f"profiled run_adaptive: wall_s={wall} device_busy_ms={busy_ms} "
          f"busy_share={busy_ms / 1e3 / wall} "
          f"round wall seconds={res['round_seconds']}")
    for key, count, ms in rows[:12] + [r for r in rows[12:]
                                       if "anen_distance" in r[0]]:
        print(f"  device {ms:.3f} ms  x{count}  {key[:90]}")


def cross_check() -> None:
    from repro_torch.apps.anen.workflow import run_adaptive
    on_gpu = run_adaptive(device="cuda", **SMALL)
    on_cpu = run_adaptive(device="cpu", **SMALL)
    diff = max(abs(a - b) for a, b in zip(on_gpu["errors"], on_cpu["errors"]))
    print(f"cross-check errors cuda={on_gpu['errors']} cpu={on_cpu['errors']} "
          f"max abs diff={diff}")
    check(on_gpu["all_done"] and on_cpu["all_done"], "cross-check all_done")
    check(len(on_gpu["errors"]) == len(on_cpu["errors"]) == SMALL["max_iters"],
          "cross-check rounds")
    # the tolerance of the JAX package's fused-vs-scalar AnEn check
    check(diff <= 1e-5, f"cuda vs cpu errors within 1e-5 (got {diff})")


# --------------------------------------------------------------------------- #
# The multi-tenant service: socket tenants share carriers, then chaos
# --------------------------------------------------------------------------- #

def service_statics(device=None) -> dict:
    """The static arguments every tenant sends: the main path's dataset.
    They are part of the fusion key, so every tenant sends the same device
    name (``"cuda"`` and ``"cuda:0"`` would never share a carrier)."""
    from repro_torch.device import device_name
    return dict(seed=MAIN["seed"], ny=MAIN["ny"], nx=MAIN["nx"],
                n_hist=MAIN["n_hist"], k=SERVICE["k"],
                device=device_name(device))


def tenant_waves(tenant: int, statics: dict) -> list:
    """The tenant's waves, each ``members`` slices of ``locs`` distinct grid
    points of the tenant's own region (one quadrant of the grid), drawn
    from the tenant's own seed."""
    import numpy as np
    rng = np.random.default_rng(1000 + tenant)
    ny, nx = statics["ny"] // 2, statics["nx"] // 2
    r0, c0 = (tenant // 2 % 2) * ny, (tenant % 2) * nx
    return [[(np.stack(np.divmod(rng.choice(ny * nx, SERVICE["locs"],
                                            replace=False), nx), axis=1)
              + (r0, c0)).tolist()
             for _ in range(SERVICE["members"])]
            for _ in range(SERVICE["waves"])]


def socket_wave(port: int, name: str, sweeps: dict, statics: dict) -> dict:
    """One wave: each tenant's thread submits its sweep over its own socket,
    waits for it and reads its results back. Returns per-tenant results,
    task states, namespace and result-fetch seconds, and the wave's wall
    from the first submit to the last tenant seeing its sweep done."""
    import threading
    from repro_torch.serve import SocketClient
    out, errors, done_at = {}, [], {}

    def tenant(t: str) -> None:
        try:
            with SocketClient("127.0.0.1", port) as client:
                resp = client._call(
                    "submit", kind="ensemble_sweep",
                    kernel="reg://analog_values",
                    sweep=[dict(statics, locations=locs)
                           for locs in sweeps[t]], tenant=t, name=name)
                check(client.wait(resp["handle"], timeout=600),
                      f"{t} {name} done")
                done_at[t] = time.perf_counter()
                t1 = time.perf_counter()
                results = client.result(resp["handle"])
                out[t] = {"results": results, "ns": resp["ns"],
                          "fetch_s": time.perf_counter() - t1,
                          "states": client.states(resp["handle"])}
        except Exception as exc:  # noqa: BLE001 - re-raised on the caller
            errors.append(f"tenant {t}: {exc!r}")

    threads = [threading.Thread(target=tenant, args=(t,)) for t in sweeps]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, f"{name}: {errors}")
    return {"tenants": out, "wall_s": max(done_at.values()) - t0}


def served_values(wave: dict, t: str, name: str, n: int) -> list:
    import numpy as np
    res = wave["tenants"][t]["results"]
    check(sorted(res) == sorted(f"{name}-{i}" for i in range(n)),
          f"{t} got exactly its own {n} results of {name}: {sorted(res)}")
    return [np.asarray(res[f"{name}-{i}"], np.float32) for i in range(n)]


def held_to_reference(values: list, sweep: list, statics: dict) -> float:
    """Max |served - compute_analogs| over a sweep, on the sweep's device
    (the plain distance: no kernel launch)."""
    import numpy as np
    import torch
    from repro_torch.apps.anen import workflow as wf
    from repro_torch.apps.anen.anen import compute_analogs
    data = wf._dataset(statics["seed"], statics["ny"], statics["nx"],
                       statics["n_hist"], statics["device"])
    worst = 0.0
    for got, locs in zip(values, sweep):
        ref = compute_analogs(data, torch.as_tensor(
            locs, device=data.hist_obs.device), statics["k"]).cpu().numpy()
        check(got.shape == ref.shape and bool(np.isfinite(got).all()),
              f"finite values of shape {ref.shape}")
        worst = max(worst, float(np.abs(got - ref).max()))
    return worst


def carrier_spans() -> list:
    """The traced carriers: (name, members, tenants, dispatch+drain ms)."""
    from repro_torch import telemetry as tel
    recs = tel.TRACER.snapshot()
    drains = {r["attrs"].get("carrier"): r["dur"] / 1e6 for r in recs
              if r["name"] == "carrier.drain"}
    return [(r["attrs"]["carrier"], r["attrs"]["members"],
             r["attrs"]["tenants"], r["dur"] / 1e6,
             drains.get(r["attrs"]["carrier"]))
            for r in recs if r["name"] == "carrier.dispatch"]


def run_service_phase(device=None) -> dict:
    """Four socket tenants, two waves each, through ``EnsembleService`` and
    ``ServiceDaemon`` on the card, then the chaos sub-phase on the same
    service. Raises on any gate; returns the phase's kernel launches."""
    import json as _json
    import socket
    import struct
    import threading
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch import telemetry as tel
    from repro_torch.apps.anen import workflow as wf
    from repro_torch.chaos import FaultSchedule
    from repro_torch.core.policies import INFRA, RETRY_TOTAL, TASK
    from repro_torch.fusion import engine
    from repro_torch.fusion.handles import to_host
    from repro_torch.kernels import anen_distance as kmod
    from repro_torch.rts.base import ResourceDescription
    from repro_torch.rts.torch_rts import CARRIERS_TOTAL
    from repro_torch.serve import EnsembleService, ServiceDaemon, SocketClient

    t_phase = time.perf_counter()
    statics = service_statics(device)
    tenants = [f"t{i}" for i in range(SERVICE["tenants"])]
    waves = {t: tenant_waves(i, statics) for i, t in enumerate(tenants)}
    n_mem, n_hist = SERVICE["members"], statics["n_hist"]
    cuda = torch.device(statics["device"]).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    service = EnsembleService(resources=ResourceDescription(
        slots=SERVICE["slots"]), serve_hold_s=SERVICE["hold_s"],
        device=device).start()
    daemon = ServiceDaemon(service, port=0).start()
    rts = service.amgr.emgr.rts
    check(all(d == torch.device(statics["device"]) for d in rts._devices),
          f"the service's TorchRTS is on {statics['device']}")
    retries0 = {c: tel.counter(RETRY_TOTAL, fault_class=c).value
                for c in (TASK, INFRA)}
    tel.enable()
    tel.TRACER.clear()
    try:
        # -- the traffic: the counts at 0 just before, read just after ---- #
        reset_counts()
        walls, served = [], {}
        for w in range(SERVICE["waves"]):
            wave = socket_wave(daemon.port, f"w{w}",
                               {t: waves[t][w] for t in tenants}, statics)
            walls.append(wave["wall_s"])
            served[w] = wave
        launches = kmod.anen_distance.launches
        shapes = dict(kmod.anen_distance.shapes)
        stats = rts.fusion_stats
        tstats = rts.tenant_stats
        carriers = rts.metrics.counter(CARRIERS_TOTAL, tier="fused").value
        spans = carrier_spans()
        metrics = service.metrics()["tenants"]
        retried = {c: tel.counter(RETRY_TOTAL, fault_class=c).value
                   - retries0[c] for c in (TASK, INFRA)}

        print(f"service: {len(tenants)} socket tenants x "
              f"{SERVICE['waves']} waves of {n_mem} members x "
              f"{SERVICE['locs']} locations, hold {SERVICE['hold_s']} s, "
              f"{SERVICE['slots']} slots on {statics['device']}")
        print(f"  wave wall seconds: {walls}")
        print(f"  anen_distance launches: {launches} "
              f"({launches / SERVICE['waves']} a wave), shapes: "
              f"{ {str(k): v for k, v in shapes.items()} }")
        print(f"  fused carriers: {carriers}; fusion_stats: {stats}")
        for name, members, mix, dispatch_ms, drain_ms in spans:
            print(f"  carrier {name}: members={members} tenants={mix} "
                  f"dispatch_ms={dispatch_ms} drain_ms={drain_ms}")
        worst = 0.0
        for t in tenants:
            ns = {served[w]["tenants"][t]["ns"] for w in served}
            fetch = [served[w]["tenants"][t]["fetch_s"] for w in served]
            print(f"  {t}: {tstats.get(t)} queue_wait="
                  f"{metrics[t]['queue_wait']} namespaces={sorted(ns)} "
                  f"result fetch seconds (host, JSON)={fetch}")
            check(len(ns) == SERVICE["waves"], f"{t}: one namespace a wave")
            for w in served:
                states = served[w]["tenants"][t]["states"]
                check(set(states.values()) == {"DONE"},
                      f"{t} w{w} all DONE: {states}")
                vals = served_values(served[w], t, f"w{w}", n_mem)
                worst = max(worst, held_to_reference(vals, waves[t][w],
                                                     statics))
        print(f"  max |served - compute_analogs|: {worst}")
        if cuda:
            print(f"  max_memory_allocated bytes: "
                  f"{torch.cuda.max_memory_allocated()}")
        check(worst <= 1e-6, f"served values within 1e-6 of compute_analogs "
                             f"(got {worst})")
        check(retried == {TASK: 0, INFRA: 0}, f"no retries ({retried})")
        check(stats["cross_tenant_carriers"] >= 1, "cross_tenant_carriers >= 1")
        for t in tenants:
            check(tstats[t]["shared_dispatches"] >= 1,
                  f"{t} shared_dispatches >= 1")
            check(tstats[t]["completions"] == SERVICE["waves"] * n_mem,
                  f"{t} completions == {SERVICE['waves'] * n_mem}")
        check(stats["scalar_fallback"] == 0 and stats["degraded"] == 0,
              "scalar_fallback == degraded == 0")
        check(stats["dispatches"] == carriers == len(spans),
              f"every carrier dispatched once ({stats['dispatches']}, "
              f"{carriers}, {len(spans)} traced)")
        check(launches == carriers,
              f"one anen_distance launch a carrier ({launches} vs {carriers})")
        check(all(s[0] == n_hist and s[1] == 3
                  and s[2] % SERVICE["locs"] == 0 for s in shapes),
              f"launch shapes (n_hist, 3, locs x B): {list(shapes)}")
        check(sorted(s[2] for s, c in shapes.items() for _ in range(c))
              == sorted(SERVICE["locs"] * m for _, m, _, _, _ in spans),
              "each launch is its carrier's width")
        check(sum(s[2] * c for s, c in shapes.items())
              == len(tenants) * SERVICE["waves"] * n_mem * SERVICE["locs"],
              "the launches cover every location once")

        # -- one more wave under the profiler: device busy share ---------- #
        if cuda:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wave = socket_wave(daemon.port, "prof",
                                   {t: waves[t][0] for t in tenants},
                                   statics)
                torch.cuda.synchronize()
            rows = device_rows(prof)
            busy = sum(r[2] for r in rows)
            print(f"profiled wave: wall_s={wave['wall_s']} device_busy_ms="
                  f"{busy} busy_share={busy / 1e3 / wave['wall_s']}")
            for key, count, ms in rows[:8]:
                print(f"  device {ms:.3f} ms  x{count}  {key[:90]}")

        # -- chaos (a): kernel faults charged to the members' budgets ----- #
        sched = FaultSchedule(CHAOS_KERNEL_SEED, {"kernel": 0.1})
        launched0 = kmod.anen_distance.launches
        rts.fault_injector = sched.kernel_fault_injector()
        try:
            handles = [service.submit(api.ensemble(
                wf.analog_values, over=[dict(statics, locations=locs)
                                        for locs in waves[t][0]],
                name=f"kb{t}", max_retries=3), tenant=t) for t in tenants]
            for h in handles:
                check(h.wait(600), f"kernel faults: {h.tenant} done")
        finally:
            rts.fault_injector = None
        tasks = [task for h in handles for p in h.compiled.pipelines
                 for s in p.stages for task in s.tasks]
        charged = sum(task.retries for task in tasks)
        faults = sum(1 for site, _ in sched.story() if site == "kernel")
        worst = max(held_to_reference(
            [to_host(h.result(f"kb{h.tenant}-{i}")).astype(np.float32)
             for i in range(n_mem)], waves[h.tenant][0], statics)
            for h in handles)
        print(f"chaos kernel faults: {faults} fired, retries charged "
              f"{charged}, anen_distance launches "
              f"{kmod.anen_distance.launches - launched0}, "
              f"max |served - compute_analogs| {worst}")
        check(all(h.succeeded() for h in handles), "kernel faults: all DONE")
        check(faults >= 1 and charged == faults,
              f"kernel faults: retries charged == faults ({charged}, "
              f"{faults})")
        check(worst <= 1e-6, f"kernel faults: values within 1e-6 ({worst})")

        # -- chaos (b): every carrier's dispatch dies; after it the fused --- #
        # tier's breaker is open, so (c) runs on the ladder's floor
        base = {t: served_values(served[0], t, "w0", n_mem)
                for t in tenants[:2]}
        degraded0 = rts.fusion_stats["degraded"]
        launched0 = kmod.anen_distance.launches
        prev = engine.CARRIER_FAULT
        sched = FaultSchedule(17, {"carrier": 1.0})
        engine.CARRIER_FAULT = sched.carrier_fault_injector()
        try:
            wave = socket_wave(daemon.port, "ca",
                               {t: waves[t][0] for t in tenants[:2]},
                               statics)
        finally:
            engine.CARRIER_FAULT = prev
        diff = max(float(np.abs(a - b).max()) for t in tenants[:2]
                   for a, b in zip(served_values(wave, t, "ca", n_mem),
                                   base[t]))
        degraded = rts.fusion_stats["degraded"] - degraded0
        # the ladder's first rung re-runs each carrier's members as one
        # per-stage fused dispatch inside the carrier: the kernel again
        print(f"chaos carrier faults: {sum(1 for e in sched.story())} fired, "
              f"degraded={degraded}, anen_distance launches "
              f"{kmod.anen_distance.launches - launched0}, wall_s="
              f"{wave['wall_s']}, max diff to the fault-free wave {diff}, "
              f"breakers {rts.breakers.states()}")
        for t in tenants[:2]:
            check(set(wave["tenants"][t]["states"].values()) == {"DONE"},
                  f"carrier faults: {t} all DONE")
        check(degraded >= 1, "carrier faults: degraded >= 1")
        check(diff <= 1e-6, f"carrier faults: values within 1e-6 ({diff})")

        # -- chaos (c): a connection dropped mid-submit ------------------- #
        sched = FaultSchedule(29, {"socket": 1.0})
        dropped = threading.Event()
        admit = service.submit

        def submit_then_await_drop(*args, **kwargs):
            # the drop must land between admission and the accept response:
            # a warm daemon could answer before the client's close arrives
            handle = admit(*args, **kwargs)
            dropped.wait(10)
            return handle

        service.submit = submit_then_await_drop
        try:
            conn = socket.create_connection(("127.0.0.1", daemon.port),
                                            timeout=10)
            req = {"id": 1, "op": "submit", "tenant": "dropper",
                   "kernel": "reg://analog_values", "name": "drop",
                   "sweep": [dict(statics, locations=locs)
                             for locs in waves["t0"][1][:4]]}
            conn.sendall((_json.dumps(req) + "\n").encode("utf-8"))
            check(sched.drops_socket("dropper:1"), "socket drop scheduled")
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
            conn.close()
            dropped.set()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                snap = service.admission.snapshot().get("dropper", {})
                if (daemon.abandoned_submits == 1
                        and snap.get("in_flight_members", 0) == 0):
                    break
                time.sleep(0.02)
        finally:
            service.submit = admit
        snap = service.admission.snapshot().get("dropper", {})
        check(daemon.abandoned_submits == 1, "socket drop: abandoned")
        check(snap.get("in_flight_members", 0) == 0
              and snap.get("active_workflows", 0) == 0,
              f"socket drop: admission refunded ({snap})")
        with SocketClient("127.0.0.1", daemon.port) as client:
            h = client.submit("reg://analog_values",
                              [dict(statics, locations=locs)
                               for locs in waves["t1"][1][:4]],
                              tenant="t1", name="after-drop")
            check(client.wait(h, timeout=600), "after the drop: served")
            check(set(client.states(h).values()) == {"DONE"},
                  "after the drop: all DONE")
        print(f"chaos socket drop: abandoned={daemon.abandoned_submits}, "
              f"dropper admission {snap}, the next tenant served")
    finally:
        tel.disable()
        daemon.stop()
        service.stop()
    check(engine.CARRIER_FAULT is None, "the carrier fault hook restored")
    print(f"service phase seconds (traffic, profiled wave, chaos): "
          f"{time.perf_counter() - t_phase}")
    return {"launches": launches, "shapes": shapes, "walls": walls}


# --------------------------------------------------------------------------- #
# The seismic sweep: chain tier, then DAG tier
# --------------------------------------------------------------------------- #

def kernel_counts() -> dict:
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.anen_distance import anen_distance
    return {"anen_distance": anen_distance.launches,
            **{k: fn.launches for k, fn in KERNELS.items()}}


def run_seismic_chain(sweep: dict) -> dict:
    """``api.run`` of the forward->misfit chain alone: chain carriers of
    two composed links each, every member DONE with a finite misfit."""
    import torch
    from repro_torch import api
    from repro_torch.apps.seismic.workflow import build_misfit_chain
    from repro_torch.rts.base import ResourceDescription
    from repro_torch.rts.torch_rts import TorchRTS
    box = []

    def factory():
        box.append(TorchRTS(device="cuda", slot_oversubscribe=sweep["slots"]))
        return box[-1]

    reset_counts()
    ens = build_misfit_chain(sweep["n_events"], nx=sweep["nx"],
                             nz=sweep["nx"], nt=sweep["nt"],
                             seed=sweep["seed"], dv=sweep["dv"],
                             device="cuda")
    t0 = time.perf_counter()
    res = api.run(ens, resources=ResourceDescription(slots=sweep["slots"]),
                  rts_factory=factory, timeout=600.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = box[0].fusion_stats
    misfits = [float(s.out.result()) for s in ens.specs]
    states = set(res.task_states.values())
    res.close()
    print(f"seismic chain {sweep}: all_done={res.all_done} wall_s={wall} "
          f"fusion_stats={stats} kernel launches={kernel_counts()}")
    print(f"  misfits (first 4): {misfits[:4]}")
    check(res.all_done and states == {"DONE"}, "seismic chain: all DONE")
    check(stats["chain_carriers"] >= 1, "seismic chain: chain_carriers >= 1")
    check(stats["chain_links"] == 2 * stats["chain_carriers"],
          "seismic chain: chain_links == 2 x chain_carriers")
    check(stats["scalar_fallback"] == 0 and stats["degraded"] == 0,
          "seismic chain: scalar_fallback == degraded == 0")
    check(len(misfits) == sweep["n_events"]
          and all(math.isfinite(m) for m in misfits),
          "seismic chain: misfits finite")
    return {"wall_s": wall, "fusion_stats": stats}


def run_seismic_dag(sweep: dict) -> dict:
    """``run_misfit_chain``: forward -> misfit -> sum as one DAG carrier."""
    import torch
    from repro_torch.apps.seismic.workflow import run_misfit_chain
    kw = {k: v for k, v in sweep.items() if k not in ("n_events", "slots")}
    reset_counts()
    t0 = time.perf_counter()
    res = run_misfit_chain(sweep["n_events"], sweep["slots"], device="cuda",
                           **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = res["fusion_stats"]
    total, parts = res["total_misfit"], sum(res["misfits"])
    print(f"seismic DAG {sweep}: all_done={res['all_done']} wall_s={wall} "
          f"total_misfit={total} sum of misfits={parts} "
          f"fusion_stats={stats} kernel launches={kernel_counts()}")
    check(res["all_done"], "seismic DAG: all DONE")
    check(stats["dag_carriers"] == 1, "seismic DAG: dag_carriers == 1")
    check(stats["dispatches"] == SEISMIC_DAG_DISPATCHES,
          f"seismic DAG: {SEISMIC_DAG_DISPATCHES} dispatch(es)")
    check(stats["scalar_fallback"] == 0 and stats["degraded"] == 0,
          "seismic DAG: scalar_fallback == degraded == 0")
    check(math.isfinite(total) and abs(total - parts) <= 1e-4 * abs(parts),
          "seismic DAG: total_misfit == sum of misfits within 1e-4 relative")
    return {"wall_s": wall, "fusion_stats": stats, "total": total}


def profile_seismic_dag(sweep: dict) -> None:
    """The DAG run once more under ``torch.profiler``: wall seconds,
    device busy ms and the device's busy share (profiler overhead
    included), and the device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.apps.seismic.workflow import run_misfit_chain
    kw = {k: v for k, v in sweep.items() if k not in ("n_events", "slots")}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_misfit_chain(sweep["n_events"], sweep["slots"],
                               device="cuda", **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(res["all_done"], "profiled seismic DAG all_done")
    rows = device_rows(prof)
    busy = sum(r[2] for r in rows)
    print(f"profiled seismic DAG: wall_s={wall} device_busy_ms={busy} "
          f"busy_share={busy / 1e3 / wall} device ops="
          f"{sum(r[1] for r in rows)}")
    for key, count, ms in rows[:8]:
        print(f"  device {ms:.3f} ms  x{count}  {key[:90]}")


def cross_check_seismic() -> None:
    """The small sweep on the card against the CPU: misfits and their sum
    within 1e-4 relative (the seismic tolerance of the CPU tests)."""
    from repro_torch.apps.seismic.workflow import run_misfit_chain
    kw = {k: v for k, v in SEISMIC_SMALL.items()
          if k not in ("n_events", "slots")}
    n, slots = SEISMIC_SMALL["n_events"], SEISMIC_SMALL["slots"]
    on_gpu = run_misfit_chain(n, slots, device="cuda", **kw)
    on_cpu = run_misfit_chain(n, slots, device="cpu", **kw)
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(on_gpu["misfits"], on_cpu["misfits"]))
    print(f"seismic cross-check (cuda vs cpu, {SEISMIC_SMALL}): max relative "
          f"misfit diff {rel}; totals {on_gpu['total_misfit']} vs "
          f"{on_cpu['total_misfit']}")
    check(on_gpu["all_done"] and on_cpu["all_done"],
          "seismic cross-check all_done")
    check(rel <= 1e-4, f"seismic cuda vs cpu misfits within 1e-4 ({rel})")
    check(abs(on_gpu["total_misfit"] - on_cpu["total_misfit"])
          <= 1e-4 * abs(on_cpu["total_misfit"]),
          "seismic cuda vs cpu total within 1e-4")


# --------------------------------------------------------------------------- #
# The sharded tier over lanes of the card (and over two cards, where there
# are two)
# --------------------------------------------------------------------------- #

def places_of(kind: str, n: int) -> list:
    """``n`` lanes of the card, or the first ``n`` cards."""
    import torch
    from repro_torch.device import virtual_devices
    if kind == "lanes":
        return virtual_devices("cuda", n)
    return [torch.device("cuda", i) for i in range(n)]


def sharded_distance(shape, places: list, timer) -> dict:
    """B2 on ``places`` against B1 over the whole H on the same inputs:
    bit-equal (rows are independent), one B1 launch a place a call; then
    timed beside B1 and its plain version, and B1 alone at the shard
    shape (one place's launch). On lanes of one card the calls queue
    behind a spin (:func:`device_ms`); across cards a call's copies
    between them hold the host, so each call is timed alone on an idle
    device (:func:`call_ms`): ``timer`` is one of the two, and
    ``timed_by`` says which."""
    import torch
    from repro_torch.kernels.anen_distance import (anen_distance,
                                                   anen_distance_plain,
                                                   anen_distance_sharded)
    h, v, n = shape
    d = len(places)
    per = -(-h // d)
    fh, fn = distance_inputs(shape)
    b1, b2 = anen_distance.launches, anen_distance_sharded.launches
    got = anen_distance_sharded(fh, fn, places)
    torch.cuda.synchronize()
    check(anen_distance.launches - b1 == d
          and anen_distance_sharded.launches - b2 == d,
          f"anen_distance_sharded on {d} places at {shape}: one launch a "
          f"place")
    ref = anen_distance(fh, fn)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(torch.equal(got, ref),
          f"anen_distance_sharded bit-equal to anen_distance at {shape} on "
          f"{d} places (max abs err {err})")
    shard = fh[:per].contiguous()
    kernel = lambda: anen_distance_sharded(fh, fn, places)   # noqa: E731
    row = {"shape": list(shape), "places": d, "shard_shape": [per, v, n],
           "timed_by": timer.__name__,
           "max_abs_err": err, "ms": timer(kernel),
           "b1_ms": timer(lambda: anen_distance(fh, fn)),
           "shard_ms": timer(lambda: anen_distance(shard, fn)),
           "plain_ms": timer(lambda: anen_distance_plain(fh, fn)),
           "call_ms": call_ms(kernel),
           "b1_call_ms": call_ms(lambda: anen_distance(fh, fn))}
    row.update(distance_bound(shape))
    row["shard_bound_ms"] = distance_bound((per, v, n))["bound_ms"]
    return row


def run_sharded_anen(places: list) -> dict:
    """AnEn at full width on the sharded tier (one dag-shard carrier a
    round, the distance once a place), counts at 0 just before and read
    just after; then the same description with ``shard=False`` on the
    card: the values must be equal bit for bit."""
    import torch
    from repro_torch.apps.anen import workflow as wf
    from repro_torch.kernels.anen_distance import anen_distance
    d = len(places)
    reset_counts()
    t0 = time.perf_counter()
    res = wf.run_random(device="cuda", places=places, **SHARDED_ANEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = anen_distance.launches
    shapes = dict(anen_distance.shapes)
    t0 = time.perf_counter()
    ref = wf.run_random(device="cuda", places=places, shard=False,
                        **SHARDED_ANEN)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    # once more sharded, for its wall only: the first run's first round
    # also pays the lanes' first use
    t0 = time.perf_counter()
    again = wf.run_random(device="cuda", places=places, **SHARDED_ANEN)
    torch.cuda.synchronize()
    again_wall = time.perf_counter() - t0
    stats, rounds = res["fusion_stats"], res["rounds"]
    print(f"sharded AnEn on {d} places ({places[0]} ...): wall_s={wall} "
          f"round wall seconds={res['round_seconds']} fusion_stats={stats}")
    print(f"  anen_distance launches {launches}, shapes "
          f"{ {str(k): c for k, c in shapes.items()} }")
    print(f"  unsharded (shard=False, same places): wall_s={ref_wall} "
          f"round wall seconds={ref['round_seconds']} "
          f"fusion_stats={ref['fusion_stats']}")
    print(f"  sharded again: wall_s={again_wall} round wall seconds="
          f"{again['round_seconds']}")
    check(res["all_done"] and ref["all_done"], "sharded AnEn: all DONE")
    check(rounds == SHARDED_ANEN["max_iters"] == ref["rounds"],
          "sharded AnEn rounds")
    check(stats["shard_carriers"] >= 1 and stats["shard_carriers"] == rounds
          and stats["dag_carriers"] == rounds,
          f"sharded AnEn: one dag-shard carrier a round ({stats})")
    check(stats["sharded_dispatches"] == 2 * rounds,
          "sharded AnEn: the batched node and the refine/max segment "
          "sharded each round")
    check(stats["scalar_fallback"] == 0 and stats["degraded"] == 0,
          "sharded AnEn: scalar_fallback == degraded == 0")
    check(ref["fusion_stats"]["shard_carriers"] == 0,
          "shard=False: no shard carrier")
    check(launches == d * rounds and launches > 0
          and shapes == {SHARDED_ANEN_SHAPE: d * rounds},
          f"sharded AnEn: anen_distance once a place a dispatch at "
          f"{SHARDED_ANEN_SHAPE} (got {launches}, {shapes})")
    check(len(res["values"]) == rounds * SHARDED_ANEN["per_iter"]
          and res["values"] == ref["values"],
          "sharded AnEn values equal the shard=False run's bit for bit")
    check(res["errors"] == ref["errors"]
          and all(math.isfinite(e) for e in res["errors"]),
          "sharded AnEn errors equal and finite")
    check(again["values"] == res["values"], "sharded AnEn: second run equal")
    return {"wall_s": wall, "unsharded_wall_s": ref_wall,
            "again_wall_s": again_wall,
            "round_seconds": res["round_seconds"],
            "again_round_seconds": again["round_seconds"],
            "unsharded_round_seconds": ref["round_seconds"],
            "launches": launches, "shapes": shapes, "fusion_stats": stats}


def seismic_sweep(run, places: list, shard: bool) -> tuple:
    """One SEISMIC sweep through ``run`` (a seismic runner) on ``places``,
    and its wall seconds, up to a synchronised card."""
    import torch
    kw = {k: v for k, v in SEISMIC.items() if k not in ("n_events", "slots")}
    t0 = time.perf_counter()
    out = run(SEISMIC["n_events"], SEISMIC["slots"], device="cuda",
              places=places, shard=shard, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_graphs(stats: dict, what: str, **want) -> None:
    """The sharded tier's link-graph counts of one run: ``want`` exactly,
    and never a refused capture."""
    got = {k: stats[k] for k in ("graph_captures", "graph_replays",
                                 "graph_refusals")}
    check(got["graph_refusals"] == 0
          and all(got[k] == v for k, v in want.items()),
          f"{what}: link graphs {got}, want {want} and no refusal")


def run_sharded_seismic(places: list) -> dict:
    """The seismic sweep (SEISMIC) as a sharded DAG on ``places``, each
    place's links CUDA graphs: one capturing sweep from an empty graph
    store (each link eager, then captured), then ``SEISMIC_WARM_PAIRS``
    alternating pairs of a warm sharded sweep (every link replayed) and a
    warm ``shard=False`` one. Gates: one dag-shard carrier; misfits
    bit-equal across every run, the sum within 1e-4 relative (the CI
    bound); no refused capture, every link replayed once a place a warm
    sweep; and the reference's own CI gate, sharded no slower than
    unsharded: median unsharded wall / median warm sharded wall >= 1.0."""
    from repro_torch.apps.seismic.workflow import run_misfit_chain
    from repro_torch.fusion import engine
    d = len(places)
    engine.release_graphs()
    reset_counts()
    first, capture_wall = seismic_sweep(run_misfit_chain, places, True)
    warm, plain = [], []
    for _ in range(SEISMIC_WARM_PAIRS):
        warm.append(seismic_sweep(run_misfit_chain, places, True))
        plain.append(seismic_sweep(run_misfit_chain, places, False))
    warm_walls = [w for _, w in warm]
    plain_walls = [w for _, w in plain]
    speedup = _median(plain_walls) / _median(warm_walls)
    stats = first["fusion_stats"]
    ref = plain[0][0]
    total, want = first["total_misfit"], ref["total_misfit"]
    rel = abs(total - want) / abs(want)
    print(f"sharded seismic DAG on {d} places: capturing sweep "
          f"wall_s={capture_wall} total={total} fusion_stats={stats}")
    print(f"  warm sharded wall_s={warm_walls} unsharded wall_s="
          f"{plain_walls} (alternating pairs); median unsharded / median "
          f"sharded = {speedup}; unsharded total={want} relative diff={rel}")
    print(f"  warm sharded fusion_stats={warm[-1][0]['fusion_stats']}")
    for run, _ in [(first, 0)] + warm + plain:
        check(run["all_done"], "sharded seismic: all DONE")
        check(run["fusion_stats"]["scalar_fallback"] == 0
              and run["fusion_stats"]["degraded"] == 0,
              "sharded seismic: scalar_fallback == degraded == 0")
        check(run["misfits"] == first["misfits"],
              "sharded seismic: per-member misfits bit-equal across the "
              "capturing, warm and unsharded sweeps")
    for run, _ in [(first, 0)] + warm:
        rs = run["fusion_stats"]
        check(rs["dag_carriers"] == 1 and rs["shard_carriers"] == 1,
              "sharded seismic: one dag-shard carrier")
        check(rs["sharded_dispatches"] == SEISMIC_DAG_DISPATCHES,
              "sharded seismic: one sharded dispatch")
    for run, _ in plain:
        check(run["fusion_stats"]["shard_carriers"] == 0,
              "shard=False: no shard carrier")
    # two ensemble nodes a place: forward and misfit
    check_graphs(stats, "capturing sharded seismic sweep",
                 graph_captures=2 * d, graph_replays=0)
    for run, _ in warm:
        check_graphs(run["fusion_stats"], "warm sharded seismic sweep",
                     graph_captures=0, graph_replays=2 * d)
    check(math.isfinite(total) and rel <= 1e-4,
          f"sharded seismic: sum within 1e-4 relative ({rel})")
    check(speedup >= 1.0,
          f"sharded seismic no slower than unsharded: median unsharded "
          f"{_median(plain_walls)} s / median warm sharded "
          f"{_median(warm_walls)} s = {speedup} >= 1.0")
    return {"capture_wall_s": capture_wall, "warm_wall_s": warm_walls,
            "unsharded_wall_s": plain_walls, "speedup": speedup,
            "rel": rel, "fusion_stats": stats,
            "warm_fusion_stats": warm[-1][0]["fusion_stats"]}


def run_sharded_ensemble(places: list) -> dict:
    """The single-kernel seismic sweep with its sum gather
    (``run_misfit_ensemble``) on ``places``, ``shard=True`` and
    ``shard=False``: one dag-shard carrier, misfits bit-equal, the sum
    within 1e-4 relative, no refused capture."""
    from repro_torch.apps.seismic.workflow import run_misfit_ensemble
    res, wall = seismic_sweep(run_misfit_ensemble, places, True)
    ref, ref_wall = seismic_sweep(run_misfit_ensemble, places, False)
    stats = res["fusion_stats"]
    rel = abs(res["total_misfit"] - ref["total_misfit"]) / abs(
        ref["total_misfit"])
    print(f"run_misfit_ensemble on {len(places)} places: sharded wall_s="
          f"{wall} fusion_stats={stats}; unsharded wall_s={ref_wall} "
          f"fusion_stats={ref['fusion_stats']}; sum relative diff={rel}")
    check(res["all_done"] and ref["all_done"],
          "run_misfit_ensemble: all DONE")
    check(stats["dag_carriers"] == 1 and stats["shard_carriers"] == 1,
          "run_misfit_ensemble shard=True: one dag-shard carrier")
    check(ref["fusion_stats"]["shard_carriers"] == 0,
          "run_misfit_ensemble shard=False: no shard carrier")
    check(stats["degraded"] == 0 and stats["scalar_fallback"] == 0,
          "run_misfit_ensemble: scalar_fallback == degraded == 0")
    check_graphs(stats, "run_misfit_ensemble sharded")
    check(res["misfits"] == ref["misfits"],
          "run_misfit_ensemble: sharded misfits bit-equal to unsharded")
    check(rel <= 1e-4, f"run_misfit_ensemble: sum within 1e-4 ({rel})")
    return {"wall_s": wall, "unsharded_wall_s": ref_wall, "rel": rel}


def compressed_mean(world: int, backend: str, device: str,
                    cases=None) -> dict:
    """``ef_compressed_mean(axis_name=)`` on CUDA tensors in a group of
    ``world`` processes (``tests/_torch_ranks.py``: seeded f32 and bf16
    leaves, two steps of error feedback) against the CPU's plain version
    of the group's mean: error states equal bits, means within 1e-6 of
    the leaf's largest."""
    import tempfile
    import numpy as np
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_ranks as ranks
    cases = tuple(ranks.CASES) if cases is None else cases
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        got = ranks.spawn(world, backend, device, work, cases=cases)
    wall = time.perf_counter() - t0
    worst = 0.0
    for case in cases:
        want = ranks.expected(world, case)
        for r in range(world):
            for key, v in want[r].items():
                g = got[r][key]
                if "/error/" in key:
                    check(np.array_equal(g.view(np.uint32),
                                         v.view(np.uint32)),
                          f"compressed mean {backend} x{world} {key} rank "
                          f"{r}: error bits equal the CPU's")
                else:
                    err = float(np.abs(g - v).max()) / float(
                        np.abs(v).max())
                    worst = max(worst, err)
                    check(err <= 1e-6, f"compressed mean {backend} "
                          f"x{world} {key} rank {r}: within 1e-6 ({err})")
    row = {"backend": backend, "world": world, "device": device,
           "cases": list(cases), "max_rel_err": worst, "wall_s": wall}
    print(f"ef_compressed_mean over a {backend} group of {world} on "
          f"{device}: {row}")
    return row


def sharded_phase(kind: str = "lanes") -> dict:
    """B2, AnEn and the seismic sweeps on the sharded tier over lanes of
    the card (``kind="lanes"``) or over the first cards; then the
    compressed mean over a process group: on lanes an NCCL group of one
    and a gloo group of 4 processes sharing the card, over cards an NCCL
    group of a rank a card."""
    import torch
    if kind == "cards":
        widths = (min(4, torch.cuda.device_count()),)
        places = places_of("cards", widths[0])
    else:
        widths = SHARD_LANES
        places = places_of("lanes", SHARDED_LANES)
    timer = device_ms if kind == "lanes" else call_ms
    rows = [sharded_distance(shape, places_of(kind, d), timer)
            for d in widths for shape in SHARD_SHAPES]
    for row in rows:
        print(f"anen_distance_sharded on {kind} {row}")
    reset_counts()
    anen = run_sharded_anen(places)
    graphs = {k: anen["fusion_stats"][k] for k in ("graph_captures",
                                                    "graph_replays",
                                                    "graph_refusals")}
    print(f"sharded AnEn link graphs (first run): {graphs}")
    seismic = run_sharded_seismic(places)
    ensemble = run_sharded_ensemble(places)
    if kind == "lanes":
        mean = [compressed_mean(1, "nccl", "cuda:0", cases=("world",)),
                compressed_mean(4, "gloo", "cuda:0")]
    else:
        mean = [compressed_mean(len(places), "nccl", "cuda:{rank}",
                                cases=("world",) if len(places) != 4
                                else None)]
    return {"rows": rows, "anen": anen, "seismic": seismic,
            "ensemble": ensemble, "compressed_mean": mean,
            "places": len(places)}


def check_grad_routes() -> None:
    """Every model kernel's CUDA route takes grads: ``torch.autograd.grad``
    through its ``autograd.Function`` (one forward and one backward
    launch) against autograd through the plain forward, in f32 at the JAX
    gradient tolerance: SSD and WKV (the gradients of every input, the
    final state's gradient nonzero), and flash."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_plain)
    for name, shape in (("mamba2_ssd", (1, 64, 2, 16, 1, 8)),
                        ("mamba2_ssd", (2, 100, 4, 16, 2, 8)),
                        ("rwkv6_wkv", (1, 64, 2, 16)),
                        ("rwkv6_wkv", (2, 100, 3, 8))):
        fn, plain, bwd, _ = scan_fns(name)
        args, dout, dstate = scan_bwd_inputs(name, shape, "float32")
        args = [a.requires_grad_(True) for a in args]
        before = (fn.launches, bwd.launches)
        out, state = fn(*args)
        got = torch.autograd.grad((out, state), args, (dout, dstate))
        torch.cuda.synchronize()
        check((fn.launches, bwd.launches) == (before[0] + 1, before[1] + 1),
              f"{name} under grad: one forward and one backward launch")
        want = torch.autograd.grad(plain(*args), args, (dout, dstate))
        errs = [held_close(a, b, BWD_TOLERANCE["float32"],
                           f"{name} autograd {g} {shape}")
                for g, a, b in zip(SCAN_GRADS[name], got, want)]
        print(f"{name} autograd.grad {shape}: max abs err "
              f"{dict(zip(SCAN_GRADS[name], errs))} against autograd "
              f"through the plain forward")
    for shape in ((2, 100, 3, 64), (1, 65, 2, 160)):
        q, k, v = (a.requires_grad_(True)
                   for a in attention_inputs(shape, "float32"))
        dout = attention_inputs(shape, "float32", seed=12)[0]
        before = (flash_attention.launches, flash_attention_bwd.launches)
        out, lse = flash_attention(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        check((flash_attention.launches, flash_attention_bwd.launches)
              == (before[0] + 1, before[1] + 1),
              "flash under grad: one forward and one backward launch")
        check(not lse.requires_grad, "flash lse carries no gradient")
        ref_out, _ = flash_attention_plain(q, k, v)
        want = torch.autograd.grad(ref_out, (q, k, v), dout)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = held_close(a, b, BWD_TOLERANCE["float32"],
                             f"flash autograd {name} {shape}")
            print(f"flash autograd.grad {shape} {name}: max abs err {err} "
                  f"against autograd through the plain forward")


# --------------------------------------------------------------------------- #
# The model kernels: flash attention and the Mamba-2 SSD scan
# --------------------------------------------------------------------------- #

def _dtype(name: str):
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def attention_inputs(shape, dtype: str, seed: int = 11):
    """q, k, v ~ N(0, 1), as the JAX kernel tests draw them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .cuda().to(_dtype(dtype)) for _ in range(3)]


def ssd_inputs(shape, dtype: str, seed: int = 13):
    """x, dt = softplus(N), A = -exp(N/2), B and C ~ N/2, state0 ~ N/10,
    as the JAX kernel tests draw them; x, B, C in ``dtype``."""
    import numpy as np
    import torch
    B, T, H, P, G, N = shape
    rng = np.random.default_rng(seed)

    def draw(*s):
        return rng.standard_normal(s).astype(np.float32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    dt = _dtype(dtype)
    return [t(draw(B, T, H, P)).to(dt), t(np.log1p(np.exp(draw(B, T, H)))),
            t(-np.exp(draw(H) * 0.5)), t(draw(B, T, G, N) * 0.5).to(dt),
            t(draw(B, T, G, N) * 0.5).to(dt), t(draw(B, H, N, P) * 0.1)]


def wkv_inputs(shape, dtype: str, seed: int = 17):
    """r, k, v ~ N/2, w = exp(-exp(N/2 - 2)), u ~ 0.3 N, state0 ~ N/10, as
    the JAX kernel test draws them; r, k, v, w in ``dtype``."""
    import numpy as np
    import torch
    B, T, H, N = shape
    rng = np.random.default_rng(seed)

    def draw(*s):
        return rng.standard_normal(s).astype(np.float32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    dt = _dtype(dtype)
    r, k, v = (t(draw(B, T, H, N) * 0.5).to(dt) for _ in range(3))
    w = t(np.exp(-np.exp(draw(B, T, H, N) * 0.5 - 2.0))).to(dt)
    return [r, k, v, w, t(draw(H, N) * 0.3), t(draw(B, H, N, N) * 0.1)]


def scan_fns(name: str):
    """(wrapper, plain, backward wrapper, plain backward) of a scan."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    return (getattr(mod, name), getattr(mod, f"{name}_plain"),
            getattr(mod, f"{name}_bwd"), getattr(mod, f"{name}_bwd_plain"))


def scan_bwd_inputs(name: str, shape, dtype: str, clamped: bool = False,
                    seed: int = 19):
    """A scan's inputs (as the forward checks draw them), its output
    gradient ~ N in ``dtype`` and a final-state gradient ~ N in f32.
    ``clamped`` (WKV): a quarter of the channels decay by e^-0.5..e^-3 a
    step (uniform), so the cumsum passes -30 inside a chunk, and the 10th
    step of every chunk has w = 1e-9 in channel N/2, one that decays as
    drawn. (Where w < 1e-8 falls after the cumsum passed -30, the clamped
    formulae multiply by 1/1e-8: terms near 1e8 cancel, and an f32
    gradient, the plain version's as well, is off its f64 value by up to
    4 % on small elements; CPU tests hold that case to autograd in f64
    and to jax.grad.)"""
    import numpy as np
    import torch
    from repro_torch.kernels.mamba2_ssd import pick_chunk
    if name == "mamba2_ssd":
        args = ssd_inputs(shape, dtype)
    else:
        args = wkv_inputs(shape, dtype)
    rng = np.random.default_rng(seed)
    if clamped:
        w, q = args[3], max(1, shape[3] // 4)
        decay = rng.uniform(0.5, 3.0, (*shape[:3], q)).astype(np.float32)
        w[..., :q] = torch.from_numpy(np.exp(-decay)).cuda().to(w.dtype)
        w[:, 9::pick_chunk(shape[1]), :, shape[3] // 2] = 1e-9
    dout = torch.from_numpy(rng.standard_normal(tuple(args[0].shape))
                            .astype(np.float32)).cuda().to(_dtype(dtype))
    dstate = torch.from_numpy(rng.standard_normal(tuple(args[5].shape))
                              .astype(np.float32)).cuda()
    return args, dout, dstate


def held_close(got, ref, tol: float, what: str) -> float:
    """Raise unless |got - ref| <= tol + tol * |ref| everywhere; returns the
    max abs error."""
    import torch
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    excess = float((err - tol * ref.abs()).max())
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    check(excess <= tol, f"{what}: |err| <= {tol} + {tol}*|ref| "
                         f"(worst excess {excess})")
    return float(err.max())


def compare_flash(shape, dtype: str, causal: bool = True) -> float:
    """The forward kernel against its plain version; a second call must
    also give equal bits. Prints the route the inputs took."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     route)
    q, k, v = attention_inputs(shape, dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = TOLERANCE["flash_attention"][dtype]
    mode = "" if causal else " causal=False"
    err = held_close(out, ref_out, tol,
                     f"flash_attention{mode} {shape} {dtype}")
    lse_err = held_close(lse, ref_lse, 2e-5,
                         f"flash_attention{mode} lse {shape} {dtype}")
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"flash_attention{mode} {shape} {dtype}: equal bits on a second "
          f"call")
    print(f"flash_attention{mode} {shape} {dtype} ({route(q, k, v)} route): "
          f"max abs err out {err} lse {lse_err} (tolerance {tol}); a second "
          f"call gives equal bits")
    return err


def compare_flash_unaligned(shape, causal: bool) -> float:
    """bf16 views 2 bytes past a 16-byte boundary, which no TMA tensor
    map can describe: they must take the mma.sync kernel (chosen by shape
    in the C entry point) and meet the plain version as the wgmma route
    does, with equal bits on a second call."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     route)
    flat = [a.reshape(-1) for a in attention_inputs(
        (math.prod(shape) + 1,), "bfloat16")]
    q, k, v = (a[1:].view(shape) for a in flat)
    check(q.data_ptr() % 16 != 0 and route(q, k, v) == "mma.sync",
          f"flash_attention unaligned {shape}: the mma.sync route (got "
          f"{route(q, k, v)})")
    out, lse = flash_attention(q, k, v, causal=causal)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = TOLERANCE["flash_attention"]["bfloat16"]
    mode = "" if causal else " causal=False"
    err = held_close(out, ref_out, tol,
                     f"flash_attention{mode} unaligned {shape}")
    held_close(lse, ref_lse, 2e-5, f"flash_attention{mode} lse unaligned")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"flash_attention{mode} unaligned {shape}: equal bits on a second "
          f"call")
    print(f"flash_attention{mode} unaligned {shape} bfloat16 (mma.sync "
          f"route): max abs err out {err} (tolerance {tol}); a second call "
          f"gives equal bits")
    return err


def bwd_route_of(shape, dtype: str) -> str:
    """The backward route the C entry point must pick for aligned inputs
    of this shape and dtype."""
    if dtype == "float32":
        return "cuda-cores"
    hdp = -(-shape[3] // 16) * 16
    return ("wgmma" if shape[3] % 8 == 0 and hdp in FLASH_BWD_WGMMA_HDS
            else "mma.sync")


def compare_flash_bwd(shape, dtype: str, causal: bool = True) -> float:
    """The backward kernel against its plain version on the same q, k, v,
    out, lse (from the forward kernel) and dout: dq, dk, dv. The inputs
    must take the route their shape calls for (``bwd_route_of``), which
    it prints. The bf16 routes (tensor cores, no atomics), and without
    the causal mask every route, must give equal bits on a second call;
    the causal f32 route (CUDA cores) must stay within
    ``BWD_F32_UNCHANGED`` of the plain version, as the first port did."""
    import torch
    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain)
    q, k, v = attention_inputs(shape, dtype)
    dout = attention_inputs(shape, dtype, seed=12)[0]
    out, lse = flash_attention(q, k, v, causal=causal)
    taken = bwd_route(q, k, v, out, dout)
    check(taken == bwd_route_of(shape, dtype),
          f"flash_attention_bwd {shape} {dtype}: the "
          f"{bwd_route_of(shape, dtype)} route (got {taken})")
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    tol = BWD_TOLERANCE[dtype]
    mode = "" if causal else " causal=False"
    errs = [held_close(a, b, tol, f"flash_attention_bwd{mode} {name} "
                                  f"{shape} {dtype}")
            for name, a, b in zip(("dq", "dk", "dv"), got, want)]
    if dtype == "bfloat16" or not causal:
        again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention_bwd{mode} {shape} {dtype}: equal bits on a "
              f"second call")
    else:
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            held_close(a, b, BWD_F32_UNCHANGED,
                       f"flash_attention_bwd {name} {shape} f32 route "
                       f"unchanged")
    print(f"flash_attention_bwd{mode} {shape} {dtype} ({taken} route): max "
          f"abs err dq, dk, dv {errs} (tolerance {tol})"
          + ("; a second call gives equal bits"
             if dtype == "bfloat16" or not causal
             else f"; within {BWD_F32_UNCHANGED} (f32 route unchanged)"))
    return max(errs)



def compare_flash_bwd_unaligned(shape, causal: bool) -> float:
    """The backward on bf16 views 2 bytes past a 16-byte boundary, which
    no TMA tensor map can describe: they must take the mma.sync kernels
    (chosen by shape in the C entry point) and meet the plain version
    with equal bits on a second call, as the wgmma route does."""
    import torch
    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain)
    q, k, v = attention_inputs(shape, "bfloat16")
    dout = attention_inputs(shape, "bfloat16", seed=12)[0]
    out, lse = flash_attention(q, k, v, causal=causal)
    views = []
    for a in (q, k, v, out, dout):
        flat = torch.empty(a.numel() + 8, dtype=a.dtype, device=a.device)
        views.append(flat[1:1 + a.numel()].view(a.shape))
        views[-1].copy_(a)
    q, k, v, out, dout = views
    taken = bwd_route(q, k, v, out, dout)
    check(q.data_ptr() % 16 != 0 and taken == "mma.sync",
          f"flash_attention_bwd unaligned {shape}: the mma.sync route (got "
          f"{taken})")
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    tol = BWD_TOLERANCE["bfloat16"]
    mode = "" if causal else " causal=False"
    errs = [held_close(a, b, tol, f"flash_attention_bwd{mode} unaligned "
                                  f"{name} {shape}")
            for name, a, b in zip(("dq", "dk", "dv"), got, want)]
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd{mode} unaligned {shape}: equal bits on a "
          f"second call")
    print(f"flash_attention_bwd{mode} unaligned {shape} bfloat16 (mma.sync "
          f"route): max abs err dq, dk, dv {errs} (tolerance {tol}); a "
          f"second call gives equal bits")
    return max(errs)


def time_flash_bwd(shape, causal: bool = True) -> dict:
    """The backward kernel (device time, busy time), its plain version
    (busy time) and, as the library yardstick, the backward of
    ``scaled_dot_product_attention`` on the same inputs (``autograd.grad``
    through a retained SDPA graph: device time by CUDA events, and busy
    time), in bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain)
    q, k, v = attention_inputs(shape, "bfloat16")
    dout = attention_inputs(shape, "bfloat16", seed=12)[0]
    out, lse = flash_attention(q, k, v, causal=causal)
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True)
                  for a in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dout_t = dout.transpose(1, 2).contiguous()
    kernel = lambda: flash_attention_bwd(                          # noqa
        q, k, v, out, lse, dout, causal=causal)
    plain = lambda: flash_attention_bwd_plain(                     # noqa
        q, k, v, out, lse, dout, causal=causal)
    library = lambda: torch.autograd.grad(                         # noqa
        sdpa, (qt, kt, vt), dout_t, retain_graph=True)
    tag = f"flash_attention_bwd causal={causal} {shape}"
    row = {"shape": list(shape), "dtype": "bfloat16", "causal": causal,
           "route": bwd_route(q, k, v, out, dout),
           "ms": device_ms(kernel),
           "busy_ms": busy_ms(kernel, tag + " kernel"),
           "parts_busy_ms": bwd_parts_ms(kernel),
           "plain_ms": busy_ms(plain, tag + " plain"),
           "library_ms": device_ms(library),
           "library_busy_ms": busy_ms(library, tag + " library"),
           "call_ms": call_ms(kernel)}
    row.update(flash_bwd_bound(shape, 2, causal))
    mode = "" if causal else " causal=False"
    print(f"flash_attention_bwd{mode} {tuple(shape)} bf16 ({row['route']} "
          f"route): {row['ms']} ms a call "
          f"({row['busy_ms']} busy; by kernel {row['parts_busy_ms']}), "
          f"SDPA's backward {row['library_ms']} busy, bound "
          f"{row['bound_ms']} ({row['bound_by']})")
    return row


# the backward's three kernels, any route (names as the profiler gives
# them, e.g. "void (anonymous namespace)::dkdv_wg_kernel<128, true>(...)")
BWD_KERNEL = re.compile(r"::(delta|dkdv|dq)_(?:tc_|wg_)?kernel<")


def bwd_part(name: str):
    """Which of the backward's kernels a device op is: "delta", "dkdv",
    "dq", or None."""
    found = BWD_KERNEL.search(name)
    return found.group(1) if found else None


def bwd_parts_ms(fn, reps: int = 10) -> dict:
    """CUPTI busy ms a call of each of the backward's three kernels
    (delta, dk/dv, dq), from one trace of ``reps`` calls; None where
    every trace came back empty (not measured)."""
    rows = traced_rows(fn, reps)
    if not rows:
        return None
    parts = {part: sum(ms for key, _, ms in rows if bwd_part(key) == part)
             / reps for part in ("delta", "dkdv", "dq")}
    check(all(ms > 0 for ms in parts.values()),
          f"every backward kernel traced: {parts}")
    return parts


def compare_ssd(shape, dtype: str) -> float:
    """The forward kernel against its plain version, y and the final state,
    on the route ``SSD_FWD_ROUTES`` gives the shape (f32: the CUDA cores);
    in bf16 a second call must give equal bits."""
    import torch
    from repro_torch.kernels.mamba2_ssd import (fwd_route, mamba2_ssd,
                                                mamba2_ssd_plain)
    args = ssd_inputs(shape, dtype)
    route = fwd_route(args[0], args[3], args[4])
    want = SSD_FWD_ROUTES[tuple(shape)] if dtype == "bfloat16" \
        else "cuda-cores"
    what = f"mamba2_ssd {shape} {dtype} ({route} route)"
    check(route == want, f"{what}: the shape takes the {want} route")
    before = mamba2_ssd.routes[route]
    y, state = mamba2_ssd(*args)
    ref_y, ref_state = mamba2_ssd_plain(*args)
    torch.cuda.synchronize()
    check(mamba2_ssd.routes[route] == before + 1,
          f"{what}: one launch on its route")
    tol = TOLERANCE["mamba2_ssd"][dtype]
    err = held_close(y, ref_y, tol, f"{what} y")
    s_err = held_close(state, ref_state, tol, f"{what} state")
    if dtype == "bfloat16":
        y2, state2 = mamba2_ssd(*args)
        torch.cuda.synchronize()
        check(torch.equal(y, y2) and torch.equal(state, state2),
              f"{what}: equal bits on a second call")
    print(f"{what}: max abs err y {err} state {s_err} (tolerance {tol})"
          + ("; a second call gives equal bits" if dtype == "bfloat16"
             else ""))
    return max(err, s_err)


def compare_wkv(shape, dtype: str, clamped: bool = False) -> float:
    """The forward kernel against its plain version, out and the final
    state (at 10x out's tolerance), on the route ``WKV_FWD_ROUTES`` gives
    the shape (f32: the CUDA cores); in bf16 a second call must give equal
    bits. ``clamped``: w drawn as ``scan_bwd_inputs`` draws it to reach
    both clamps."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import (fwd_route, rwkv6_wkv,
                                               rwkv6_wkv_plain)
    if clamped:
        args = scan_bwd_inputs("rwkv6_wkv", shape, dtype, clamped=True)[0]
    else:
        args = wkv_inputs(shape, dtype)
    route = fwd_route(*args[:4])
    want = WKV_FWD_ROUTES[tuple(shape)] if dtype == "bfloat16" else "f32"
    what = (f"rwkv6_wkv {shape} {dtype}{' clamped' if clamped else ''} "
            f"({route} route)")
    check(route == want, f"{what}: the shape takes the {want} route")
    before = rwkv6_wkv.routes[route]
    out, state = rwkv6_wkv(*args)
    ref_out, ref_state = rwkv6_wkv_plain(*args)
    torch.cuda.synchronize()
    check(rwkv6_wkv.routes[route] == before + 1,
          f"{what}: one launch on its route")
    tol = TOLERANCE["rwkv6_wkv"][dtype]
    err = held_close(out, ref_out, tol, f"{what} out")
    s_err = held_close(state, ref_state, tol * 10, f"{what} state")
    if dtype == "bfloat16":
        out2, state2 = rwkv6_wkv(*args)
        torch.cuda.synchronize()
        check(torch.equal(out, out2) and torch.equal(state, state2),
              f"{what}: equal bits on a second call")
    print(f"{what}: max abs err out {err} state {s_err} (tolerance {tol}, "
          f"state {tol * 10})"
          + ("; a second call gives equal bits" if dtype == "bfloat16"
             else ""))
    return err


def compare_scan_bwd(name: str, shape, dtype: str, clamped: bool = False,
                     with_dstate: bool = True) -> float:
    """A scan's backward kernel against its plain version on the same
    inputs, output gradient and nonzero final-state gradient (or none,
    ``with_dstate`` False), at ``BWD_TOLERANCE``; a second call must give
    equal bits (its sums over blocks run in a fixed order). The call must
    take the route its shape calls for, and count one launch on it."""
    import torch
    _, _, bwd, bwd_plain = scan_fns(name)
    args, dout, dstate = scan_bwd_inputs(name, shape, dtype, clamped)
    if not with_dstate:
        dstate = None
    route = scan_bwd_route(name, args, dout)
    before = (bwd.launches, bwd.routes[route])
    got = bwd(*args, dout, dstate)
    torch.cuda.synchronize()
    check((bwd.launches, bwd.routes[route]) == (before[0] + 1,
                                                  before[1] + 1),
          f"{name}_bwd: one launch a call, on its {route} route")
    want = bwd_plain(*args, dout, dstate)
    tol = BWD_TOLERANCE[dtype]
    what = (f"{name}_bwd {shape} {dtype}" + (" clamped" if clamped else "")
            + ("" if with_dstate else " (no dstate_T)"))
    errs = [held_close(a, b, tol, f"{what} {g}")
            for g, a, b in zip(SCAN_GRADS[name], got, want)]
    for g, a, x in zip(SCAN_GRADS[name], got, args):
        check(a.dtype == x.dtype and a.shape == x.shape,
              f"{what} {g}: its input's dtype and shape")
    again = bwd(*args, dout, dstate)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: equal bits on a second call")
    what += f" ({route} route)"
    if name == "mamba2_ssd" and dtype == "bfloat16" \
            and tuple(shape) == SSD_MAIN:
        check(route == "cluster",
              f"{what}: the train shape takes the cluster route")
    if name == "rwkv6_wkv" and dtype == "bfloat16":
        want_route = "wgmma" if shape[3] == 64 and shape[1] % 64 == 0 \
            else "mma"
        check(route == want_route, f"{what}: the shape takes the "
                                   f"{want_route} route")
    if dtype == "float32":
        digest = scan_bwd_digest(got)
        was = SCAN_BWD_F32_DIGEST[(name, tuple(shape), clamped)]
        check(digest == was, f"{what}: f32 route unchanged (digest {digest}, "
                             f"commit ff86033's {was})")
    print(f"{what}: max abs err {dict(zip(SCAN_GRADS[name], errs))} "
          f"(tolerance {tol}); a second call gives equal bits"
          + ("; the f32 route's bits are commit ff86033's"
             if dtype == "float32" else ""))
    return max(errs)


def scan_bwd_route(name: str, args, dout) -> str:
    """A scan backward's route on these inputs, as its ``bwd_route``
    reports it: SSD "cluster", "mma.sync" or "cuda-cores"; WKV "wgmma",
    "mma" or "f32"."""
    if name == "mamba2_ssd":
        from repro_torch.kernels.mamba2_ssd import bwd_route
        return bwd_route(args[0], args[3], args[4], dout)
    from repro_torch.kernels.rwkv6_wkv import bwd_route
    return bwd_route(*args[:4], dout)


def scan_bwd_digest(grads) -> str:
    """The first 16 hex digits of the sha256 of the gradients' bytes, in
    order."""
    import hashlib
    h = hashlib.sha256()
    for g in grads:
        h.update(g.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]




# the bf16 scan backwards' kernels (names as the profiler gives them, e.g.
# "void (anonymous namespace)::wg::wkv_bwd_wg_kernel(...)"): SSD's cluster
# route and WKV's wgmma route at the train shape; each then its
# fixed-order sums
SCAN_BWD_KERNEL = re.compile(
    r"::(?:ssd|wkv)_bwd_(walk|chunk|cluster|wg|reduce)_kernel")
SCAN_BWD_PARTS = {"mamba2_ssd": ("cluster", "reduce"),
                  "rwkv6_wkv": ("wg", "reduce")}


def scan_bwd_workspace_bytes(name: str, shape) -> int:
    """Bytes the bf16 route moves through its f32 workspaces beyond the
    function's own (not in the bound), written and read back. SSD on the
    cluster route: the head groups' partial dB and dC and dA's partials
    (the chunk states never leave the cluster); on the mma.sync route the
    chunk states and their gradients (walk to chunk kernel) and the
    per-head dB and dC. WKV on the wgmma route: the chunk states' bf16 hi
    and lo tiles; on the mma.sync route the chunk states and their
    gradients (f32)."""
    import torch
    from repro_torch.kernels import mamba2_ssd
    from repro_torch.kernels.mamba2_ssd import pick_chunk
    if name == "mamba2_ssd":
        B, T, H, P, G, N = shape
        K = T // pick_chunk(T)
        if mamba2_ssd._bwd_route(shape, torch.bfloat16, (0, 0, 0, 0),
                                 64) == "cluster":
            groups = H // mamba2_ssd.cluster_heads(H)
            return 2 * (2 * B * T * groups * N * 4 + B * H * K * 4)
        state = B * H * K * N * P * 4
        return 2 * 2 * state + 2 * 2 * B * T * H * N * 4
    from repro_torch.kernels import rwkv6_wkv
    B, T, H, N = shape
    states = B * H * (T // pick_chunk(T)) * N * N * 4
    if rwkv6_wkv._fwd_route(shape, torch.bfloat16, (0,) * 5,
                            64) == "wgmma":
        return 2 * states
    return 2 * 2 * states


def scan_bwd_parts_ms(name: str, fn, reps: int = 10) -> dict:
    """CUPTI busy ms a call of each of the bf16 scan backward's kernels,
    from one trace of ``reps`` calls; None where every trace came back
    empty (not measured)."""
    rows = traced_rows(fn, reps)
    if not rows:
        return None
    parts = {}
    for key, _, ms in rows:
        found = SCAN_BWD_KERNEL.search(key)
        if found:
            parts[found.group(1)] = parts.get(found.group(1), 0.0) + ms / reps
    check(set(parts) == set(SCAN_BWD_PARTS[name]),
          f"every {name} backward kernel traced: {parts}")
    return {part: parts[part] for part in SCAN_BWD_PARTS[name]}


def time_scan_bwd(name: str, shape) -> dict:
    """The backward kernel at its train shape in bf16, as the train step
    calls it (no final-state gradient): device time, busy time (also by
    kernel) and its plain version's busy time; no single PyTorch call
    computes it. Also printed, outside the kernels line: the bytes the
    design moves through its f32 workspaces, counted from the shape."""
    _, _, bwd, bwd_plain = scan_fns(name)
    args, dout, _ = scan_bwd_inputs(name, shape, "bfloat16")
    kernel = lambda: bwd(*args, dout)                         # noqa: E731
    plain = lambda: bwd_plain(*args, dout)                    # noqa: E731
    tag = f"{name}_bwd {shape}"
    row = {"shape": list(shape), "dtype": "bfloat16",
           "ms": device_ms(kernel),
           "busy_ms": busy_ms(kernel, tag + " kernel"),
           "parts_busy_ms": scan_bwd_parts_ms(name, kernel),
           "plain_ms": busy_ms(plain, tag + " plain"),
           "library_ms": None,
           "call_ms": call_ms(kernel)}
    row.update((ssd_bwd_bound if name == "mamba2_ssd" else wkv_bwd_bound)(
        shape, 2))
    row["route"] = scan_bwd_route(name, args, dout)
    row["workspace_bytes"] = scan_bwd_workspace_bytes(name, shape)
    print(f"{name}_bwd {tuple(shape)} bf16 ({row['route']} route): "
          f"{row['ms']} ms a call "
          f"({row['busy_ms']} busy; by kernel {row['parts_busy_ms']}), "
          f"plain {row['plain_ms']} busy, bound {row['bound_ms']} "
          f"({row['bound_by']}; f32 CUDA-core floor "
          f"{row['f32_cuda_core_ops_ms']})")
    work = row["workspace_bytes"]
    print(f"{name}_bwd {tuple(shape)} bf16 workspace traffic (counted from "
          f"the shape, not measured): {work} bytes, "
          f"{work / HBM_BYTES_PER_S * 1e3} ms at the memory rate")
    return row


def compiled_kernels(anen_n: int) -> dict:
    """Registers, shared memory and blocks an SM of every compiled kernel
    at its main path's shape: flash, SSD and WKV for each route (dtype),
    flash also at head dim 160 (keys ``("flash_attention", dtype, 160)``),
    the bf16 backward's dk/dv and dq kernels at ``BWD_INFO_HDS`` (a spill
    at the train shape's head dim fails), the SSD and WKV backward kernels
    for each dtype at their train shapes (SSD bf16: the cluster route's
    kernel, which must fit a cluster of the train shape's chunks on the
    card, and the mma.sync route's chunk kernel and walk under keys
    ``("mamba2_ssd_bwd", "bfloat16", "chunk" | "walk")``; WKV bf16: the
    wgmma route's kernel, and the mma.sync route's chunk kernel and walk
    under ``("rwkv6_wkv_bwd", "bfloat16", "chunk" | "walk")``; a spill
    fails), and ``anen_distance`` at ``anen_n`` columns."""
    import torch
    from repro_torch.kernels import (anen_distance, flash_attention,
                                     mamba2_ssd, rwkv6_wkv)
    from repro_torch.kernels.mamba2_ssd import pick_chunk
    B, T, H, P, G, N = SSD_MAIN
    info = {("anen_distance", "float32"): anen_distance.kernel_info(anen_n)}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        info[("flash_attention", name)] = flash_attention.kernel_info(
            FLASH_MAIN[3], dtype)
        info[("flash_attention", name, 160)] = flash_attention.kernel_info(
            160, dtype)
        info[("flash_attention_bwd", name)] = flash_attention.bwd_kernel_info(
            FLASH_QWEN2_VL[3], dtype, "dkdv")
        info[("flash_attention_bwd", name, "dq")] = \
            flash_attention.bwd_kernel_info(FLASH_QWEN2_VL[3], dtype, "dq")
        info[("mamba2_ssd", name)] = mamba2_ssd.kernel_info(
            N, P, pick_chunk(T), dtype,
            "warpgroup" if dtype == torch.bfloat16 else None)
        info[("rwkv6_wkv", name)] = rwkv6_wkv.kernel_info(
            WKV_MAIN[3], pick_chunk(WKV_MAIN[1]), dtype,
            "wgmma" if dtype == torch.bfloat16 else None)
        info[("mamba2_ssd_bwd", name)] = mamba2_ssd.bwd_kernel_info(
            N, P, pick_chunk(T), dtype,
            "cluster" if dtype == torch.bfloat16 else "chunk")
        info[("rwkv6_wkv_bwd", name)] = rwkv6_wkv.bwd_kernel_info(
            WKV_MAIN[3], pick_chunk(WKV_MAIN[1]), dtype,
            "wgmma" if dtype == torch.bfloat16 else "chunk")
    info[("mamba2_ssd", "bfloat16", "mma.sync")] = mamba2_ssd.kernel_info(
        N, P, pick_chunk(T), torch.bfloat16)
    info[("rwkv6_wkv", "bfloat16", "mma")] = rwkv6_wkv.kernel_info(
        WKV_MAIN[3], pick_chunk(WKV_MAIN[1]), torch.bfloat16)
    for part in ("chunk", "walk"):
        info[("mamba2_ssd_bwd", "bfloat16", part)] = \
            mamba2_ssd.bwd_kernel_info(N, P, pick_chunk(T), torch.bfloat16,
                                       part)
    for part in ("chunk", "walk"):
        info[("rwkv6_wkv_bwd", "bfloat16", part)] = \
            rwkv6_wkv.bwd_kernel_info(WKV_MAIN[3], pick_chunk(WKV_MAIN[1]),
                                      torch.bfloat16, part)
    for hd in BWD_INFO_HDS:
        for which in ("dkdv", "dq"):
            info[("flash_attention_bwd", "bfloat16", f"{which} hd {hd}")] = \
                flash_attention.bwd_kernel_info(hd, torch.bfloat16, which)
    for (kernel, name, *hd), row in info.items():
        at = f" ({hd[0]})" if hd else ""
        print(f"compiled {kernel} {name} route{at}: {row}")
    for which in ("dkdv", "dq"):
        row = info[("flash_attention_bwd", "bfloat16",
                    f"{which} hd {FLASH_QWEN2_VL[3]}")]
        check(row["spill_bytes"] == 0,
              f"flash_attention_bwd bf16 {which} kernel spills nothing at "
              f"hd {FLASH_QWEN2_VL[3]} (got {row['spill_bytes']} bytes)")
    for (kernel, name, *rest), row in info.items():
        if kernel in ("mamba2_ssd_bwd", "rwkv6_wkv_bwd"):
            check(row["spill_bytes"] == 0,
                  f"{kernel} {name} {rest} kernel spills nothing at the "
                  f"train shape (got {row['spill_bytes']} bytes)")
    clusters = mamba2_ssd.bwd_max_clusters(T // pick_chunk(T))
    print(f"mamba2_ssd_bwd cluster route: {clusters} clusters of "
          f"{T // pick_chunk(T)} blocks fit the card at once "
          f"(cudaOccupancyMaxActiveClusters)")
    check(clusters >= 1, "a cluster of the SSD backward's train-shape chunks "
                         "fits the card")
    info[("mamba2_ssd_bwd", "bfloat16")]["max_active_clusters"] = clusters
    wg = info[("mamba2_ssd", "bfloat16")]
    check(wg["spill_bytes"] == 0 and wg["threads"] == 128
          and wg["blocks_per_sm"] >= 4,
          f"the SSD forward's warpgroup kernel: one warpgroup, no spill, 4 "
          f"blocks an SM (zamba2's {B * H} (b, h) in one wave) ({wg})")
    wg = info[("rwkv6_wkv", "bfloat16")]
    check(wg["spill_bytes"] == 0 and wg["threads"] == 384
          and wg["blocks_per_sm"] >= 2,
          f"the WKV forward's wgmma kernel: three warpgroups, no spill, 2 "
          f"blocks an SM (rwkv6-3b's {WKV_MAIN[0] * WKV_MAIN[2]} (b, h) in "
          f"one wave) ({wg})")
    wg = info[("rwkv6_wkv_bwd", "bfloat16")]
    check(wg["spill_bytes"] == 0 and wg["threads"] == 384
          and wg["blocks_per_sm"] >= 1,
          f"the WKV backward's wgmma kernel: three warpgroups, no spill, a "
          f"block an SM ({wg})")
    return info


# the fused residual add and RMSNorm: chatglm3-6b's 4 x 512 prefill, its
# final norm's rows, and the widest row at many rows
NORM_SHAPES = ((2048, 4096), (4, 4096), (8192, 4096), (1024, 8192))
NORM_TIMED = (2048, 4096)


def check_norm() -> dict:
    """The fused norm against the plain chain on the card at
    ``NORM_SHAPES``, with and without the residual add: h the bits of x +
    delta, y within one bf16 ulp, the same bits on a second call, one
    launch a call on the fused route, and no spill; then its device time
    (warm, CUDA events) beside the chain's busy time and its bound at
    ``NORM_TIMED``."""
    import torch
    from repro_torch.kernels import rms_norm as rn
    rows = []
    for shape in NORM_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        delta = torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        scale = torch.rand(shape[1], generator=gen, device="cuda") + 0.5
        for with_delta in (True, False):
            d = delta if with_delta else None
            check(rn.fwd_route(x, scale, d) == "fused",
                  f"rms_norm at {shape} takes the fused route")
            before = rn.rms_norm.launches
            if with_delta:
                (h, y), (h2, y2) = (rn.add_rms_norm(x, delta, scale, 1e-5)
                                    for _ in range(2))
                ref = x + delta
                check(torch.equal(h.view(torch.int16), ref.view(torch.int16))
                      and torch.equal(h2.view(torch.int16),
                                      h.view(torch.int16)),
                      f"rms_norm at {shape}: h == x + delta bit for bit")
            else:
                y, y2 = (rn.rms_norm(x, scale, 1e-5) for _ in range(2))
                ref = x
            torch.cuda.synchronize()
            plain = rn.rms_norm_plain(ref, scale, 1e-5)
            ulps = int((y.view(torch.int16).int()
                        - plain.view(torch.int16).int()).abs().max())
            info = rn.kernel_info(*shape, with_delta)
            row = {"shape": list(shape), "delta": with_delta,
                   "max_ulps": ulps, **info}
            print(f"rms_norm {row}")
            check(rn.rms_norm.launches == before + 2,
                  f"rms_norm at {shape}: one launch a call")
            check(ulps <= 1, f"rms_norm at {shape}, delta {with_delta}: y "
                             f"within one bf16 ulp of the chain ({ulps})")
            check(torch.equal(y2.view(torch.int16), y.view(torch.int16)),
                  f"rms_norm at {shape}: equal bits on a second call")
            check(info["spill_bytes"] == 0,
                  f"rms_norm at {shape}, delta {with_delta}: no spill "
                  f"({info})")
            if tuple(shape) == NORM_TIMED:
                row["ms"] = device_ms(
                    (lambda: rn.add_rms_norm(x, delta, scale, 1e-5))
                    if with_delta else (lambda: rn.rms_norm(x, scale, 1e-5)))
                row["plain_ms"] = busy_ms(
                    (lambda: rn.rms_norm_plain(x + delta, scale, 1e-5))
                    if with_delta
                    else (lambda: rn.rms_norm_plain(x, scale, 1e-5)),
                    f"rms_norm plain at {shape}")
                row.update({k: v for k, v in norm_bound(
                    shape, 2, with_delta).items()
                    if k in ("bound_ms", "bound_by")})
                print(f"rms_norm timed (warm L2) {row}")
            rows.append(row)
    return {"rows": rows}


def time_flash(shape, causal: bool = True) -> dict:
    """The forward kernel (device time, busy time), its plain version
    (busy time) and ``scaled_dot_product_attention`` on the same inputs
    (device time by CUDA events, and busy time), in bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     route)
    q, k, v = attention_inputs(shape, "bfloat16")
    # the library yardstick takes (B, H, S, hd); it is timed here only
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    kernel = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: flash_attention_plain(                    # noqa: E731
        q, k, v, causal=causal)
    library = lambda: F.scaled_dot_product_attention(         # noqa: E731
        qt, kt, vt, is_causal=causal)
    tag = f"flash_attention causal={causal} {shape}"
    row = {"shape": list(shape), "dtype": "bfloat16", "causal": causal,
           "route": route(q, k, v),
           "ms": device_ms(kernel),
           "busy_ms": busy_ms(kernel, tag + " kernel"),
           "plain_ms": busy_ms(plain, tag + " plain"),
           "library_ms": device_ms(library),
           "library_busy_ms": busy_ms(library, tag + " library"),
           "call_ms": call_ms(kernel)}
    row.update(flash_bound(shape, 2, causal))
    return row


def compiled_forward_kernels() -> dict:
    """Registers, shared memory, threads and blocks an SM of the bf16
    flash forward in both modes at ``FLASH_FWD_INFO_HDS``, keyed
    ``(causal, hd)``: each must be the wgmma kernel (384 threads) and
    spill nothing."""
    import torch
    from repro_torch.kernels import flash_attention
    info = {}
    for causal in (True, False):
        for hd in FLASH_FWD_INFO_HDS:
            row = flash_attention.kernel_info(hd, torch.bfloat16, causal)
            info[(causal, hd)] = row
            print(f"compiled flash_attention bf16 forward causal={causal} "
                  f"hd {hd}: {row}")
            check(row["route"] == "wgmma" and row["threads"] == 384,
                  f"flash bf16 forward causal={causal} hd {hd} takes the "
                  f"wgmma kernel (got {row['route']}, {row['threads']} "
                  f"threads)")
            check(row["spill_bytes"] == 0,
                  f"flash bf16 forward causal={causal} hd {hd} spills "
                  f"nothing (got {row['spill_bytes']} bytes)")
    return info


def compiled_backward_kernels() -> dict:
    """Registers, shared memory, threads and blocks an SM of the bf16
    flash backward's dk/dv and dq kernels in both modes at
    ``FLASH_BWD_WGMMA_HDS``, keyed ``(causal, which, hd)``: each must be
    the wgmma kernel (384 threads) and spill nothing; hd 150 and 160
    report the mma.sync kernels."""
    import torch
    from repro_torch.kernels import flash_attention
    info = {}
    for causal in (True, False):
        for hd in (*FLASH_BWD_WGMMA_HDS, 150, 160):
            for which in ("dkdv", "dq"):
                row = flash_attention.bwd_kernel_info(hd, torch.bfloat16,
                                                      which, causal)
                info[(causal, which, hd)] = row
                print(f"compiled flash_attention_bwd bf16 {which} "
                      f"causal={causal} hd {hd}: {row}")
                want = ("wgmma" if hd in FLASH_BWD_WGMMA_HDS
                        else "mma.sync")
                check(row["route"] == want
                      and (row["threads"] == 384) == (want == "wgmma"),
                      f"flash bf16 backward {which} causal={causal} hd "
                      f"{hd} takes the {want} kernel (got {row['route']}, "
                      f"{row['threads']} threads)")
                check(row["spill_bytes"] == 0,
                      f"flash bf16 backward {which} causal={causal} hd "
                      f"{hd} spills nothing (got {row['spill_bytes']} "
                      f"bytes)")
    return info


def compiled_full_kernels() -> dict:
    """Registers, shared memory and blocks an SM of the bf16 flash
    kernels without the causal mask (forward, dk/dv, dq) at
    ``FLASH_FULL_INFO_HDS``; a spill fails."""
    import torch
    from repro_torch.kernels import flash_attention
    info = {}
    for hd in FLASH_FULL_INFO_HDS:
        info[f"forward hd {hd}"] = flash_attention.kernel_info(
            hd, torch.bfloat16, causal=False)
        for which in ("dkdv", "dq"):
            info[f"{which} hd {hd}"] = flash_attention.bwd_kernel_info(
                hd, torch.bfloat16, which, causal=False)
    for key, row in info.items():
        print(f"compiled flash_attention bf16 causal=False {key}: {row}")
        check(row["spill_bytes"] == 0,
              f"flash bf16 causal=False {key} spills nothing (got "
              f"{row['spill_bytes']} bytes)")
    return info


def run_noncausal_path() -> dict:
    """``flash_attention(causal=False)`` through its entry point under
    grad, as bidirectional attention in a train step takes it: at
    (4, 512, 12, 128) and (4, 512, 32, 112) in bf16, one forward and one
    backward launch each, counted from 0, with no causal launch among
    them; each gradient within the bf16 gate of autograd through the
    plain forward."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_plain)
    shapes = FLASH_FULL_BWD_TIMED
    inputs = []
    for shape in shapes:
        q, k, v = (a.requires_grad_(True)
                   for a in attention_inputs(shape, "bfloat16", seed=21))
        inputs.append((q, k, v, attention_inputs(shape, "bfloat16",
                                                  seed=22)[0]))
    torch.cuda.synchronize()
    reset_counts()
    grads = []
    for q, k, v, dout in inputs:
        out, _ = flash_attention(q, k, v, causal=False)
        grads.append(torch.autograd.grad(out, (q, k, v), dout))
    torch.cuda.synchronize()
    counts = {"flash_attention_noncausal": flash_attention.noncausal_launches,
              "flash_attention_bwd_noncausal":
                  flash_attention_bwd.noncausal_launches}
    check(counts == {"flash_attention_noncausal": len(shapes),
                     "flash_attention_bwd_noncausal": len(shapes)}
          and flash_attention.launches == len(shapes)
          and flash_attention_bwd.launches == len(shapes),
          f"the non-causal path: one forward and one backward launch a "
          f"shape, none causal (got {counts}, all "
          f"{flash_attention.launches}, {flash_attention_bwd.launches})")
    for shape, (q, k, v, dout), got in zip(shapes, inputs, grads):
        ref, _ = flash_attention_plain(q, k, v, causal=False)
        want = torch.autograd.grad(ref, (q, k, v), dout)
        errs = [held_close(a, b, BWD_TOLERANCE["bfloat16"],
                           f"flash causal=False autograd {name} {shape}")
                for name, a, b in zip(("dq", "dk", "dv"), got, want)]
        print(f"flash causal=False autograd.grad {shape} bf16: max abs err "
              f"dq, dk, dv {errs} against autograd through the plain "
              f"forward")
    print(f"non-causal path launches: {counts}")
    return counts


def time_ssd(shape) -> dict:
    from repro_torch.kernels.mamba2_ssd import (fwd_route, mamba2_ssd,
                                                mamba2_ssd_plain)
    args = ssd_inputs(shape, "bfloat16")
    kernel = lambda: mamba2_ssd(*args)                        # noqa: E731
    plain = lambda: mamba2_ssd_plain(*args)                   # noqa: E731
    tag = f"mamba2_ssd {shape}"
    row = {"shape": list(shape), "dtype": "bfloat16",
           "ms": device_ms(kernel),
           "busy_ms": busy_ms(kernel, tag + " kernel"),
           "plain_ms": busy_ms(plain, tag + " plain"),
           "library_ms": None,
           "call_ms": call_ms(kernel),
           "route": fwd_route(args[0], args[3], args[4])}
    row.update(ssd_bound(shape, 2))
    return row


def time_wkv(shape, dtype: str = "bfloat16") -> dict:
    """The bf16 route (tensor cores) against its bound at the tensor-core
    rate; the f32 route (CUDA cores) against its bound at the f32 rate."""
    from repro_torch.kernels.rwkv6_wkv import (fwd_route, rwkv6_wkv,
                                               rwkv6_wkv_plain)
    args = wkv_inputs(shape, dtype)
    kernel = lambda: rwkv6_wkv(*args)                         # noqa: E731
    plain = lambda: rwkv6_wkv_plain(*args)                    # noqa: E731
    tag = f"rwkv6_wkv {dtype} {shape}"
    row = {"shape": list(shape), "dtype": dtype,
           "ms": device_ms(kernel),
           "busy_ms": busy_ms(kernel, tag + " kernel"),
           "plain_ms": busy_ms(plain, tag + " plain"),
           "library_ms": None,
           "call_ms": call_ms(kernel),
           "route": fwd_route(*args[:4])}
    if dtype == "bfloat16":
        row.update(wkv_bound(shape, 2))
    else:
        row.update(wkv_bound(shape, 4, FP32_FLOPS_PER_S))
    return row


# --------------------------------------------------------------------------- #
# The serve paths: zamba2-7b, rwkv6-3b and the dense models at full width
# --------------------------------------------------------------------------- #

def per_batch_launches(cfg) -> dict:
    """Kernel launches one served batch's prefill makes, by kernel."""
    if cfg.family == "ssm":
        return {"flash_attention": 0, "mamba2_ssd": 0,
                "rwkv6_wkv": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.n_layers // cfg.attn_every,
                "mamba2_ssd": cfg.n_layers, "rwkv6_wkv": 0}
    return {"flash_attention": cfg.n_layers, "mamba2_ssd": 0,
            "rwkv6_wkv": 0}


def norm_launches_per_prefill(cfg) -> int:
    """Fused norm launches one served batch's prefill makes: each
    attention application's two pre-norms (the second with the residual
    add in front of it), each Mamba-2 layer's pre-norm and gated
    out-norm, each RWKV layer's first pre-norm (its second is taken of the
    float32 sum, on the plain chain by design), and the final norm. A
    decode step makes as many."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return L + 1
    if cfg.family == "hybrid":
        return 2 * L + 2 * (L // cfg.attn_every) + 1
    return 2 * L + 1


# fused norm launches by serve path (check_norm_routes)
NORM_LAUNCHES = {}


def check_norm_routes(arch: str, cfg, launches: int, routes: dict,
                      want: int) -> None:
    """``want`` fused norm launches on a path, each its own fused call,
    and (but for RWKV's float32 second norm) no norm on the plain
    chain."""
    NORM_LAUNCHES[arch] = launches
    print(f"{arch} rms_norm launches {launches} (want {want}), routes "
          f"{routes}")
    check(launches == want and routes.get("fused", 0) == launches,
          f"{arch}: {want} fused norm launches on the path (got "
          f"{launches}, routes {routes})")
    if cfg.family != "ssm":
        check(routes.get("plain", 0) == 0,
              f"{arch}: every serve norm on the fused route ({routes})")


def release_sessions() -> None:
    """Drop the served models' weights, so that a serve phase's peak memory
    is its own (the AnEn dataset stays cached)."""
    import gc
    import torch
    from repro_torch.launch import serve
    serve._SESSIONS.clear()
    gc.collect()
    torch.cuda.empty_cache()


def run_serve_path(traffic: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve
    from repro_torch.models.config import get_config
    arch = traffic["arch"]
    cfg = get_config(arch)
    per_batch = per_batch_launches(cfg)
    n = traffic["n_batches"]
    release_sessions()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    amgr = serve.run_managed(arch, smoke=False, n_batches=n,
                             batch_size=traffic["batch_size"],
                             prompt_len=traffic["prompt_len"],
                             max_new_tokens=traffic["max_new_tokens"],
                             device="cuda", timeout=600.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    shapes = {k: dict(fn.shapes) for k, fn in KERNELS.items()}
    sess = serve.get_session(arch, False, "cuda")
    tasks = [t for p in amgr.workflow for s in p.stages for t in s.tasks]
    print(f"serve {traffic}: all_done={amgr.all_done} wall_s={wall} "
          f"session build seconds={sess.build_seconds}")
    print(f"max_memory_allocated bytes: {torch.cuda.max_memory_allocated()} "
          f"(held before the phase: {held})")
    print(f"serve path launches: {launches}, shapes: "
          f"{ {k: {str(s): c for s, c in v.items()} for k, v in shapes.items()} }")
    check(amgr.all_done, f"{arch} serve all_done")
    check(len(tasks) == n, f"{n} serve tasks")
    check(all(t.retries == 0 for t in tasks), "no serve task retried")
    for t in tasks:
        tokens = np.asarray(t.result)
        check(tokens.shape == (traffic["batch_size"],
                               traffic["max_new_tokens"]),
              f"{t.name} tokens shape {tokens.shape}")
        check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
              f"{t.name} tokens in [0, {cfg.vocab_size})")
    stats = sess.stats[-n:]
    norms = norm_launches_per_prefill(cfg)
    for rec in stats:
        print(f"  batch: prefill_s={rec['prefill_s']} decode_s_per_token="
              f"{rec['decode_s_per_token']} launches="
              f"{ {k: rec[k + '_launches'] for k in per_batch} } "
              f"rms_norm_launches={rec['rms_norm_launches']}")
        check(rec["prefill_logits_finite"], "prefill logits finite")
        check(rec["decode_logits_finite"], "decode logits finite")
        for name, want in per_batch.items():
            check(rec[f"{name}_launches"] == want,
                  f"{name}: {want} launches per batch")
        check(rec["rms_norm_launches"] == norms,
              f"{arch}: {norms} fused norms a batch's prefill (got "
              f"{rec['rms_norm_launches']})")
    check_norm_routes(arch, cfg, launches["rms_norm"],
                      dict(KERNELS["rms_norm"].routes),
                      norms * n * traffic["max_new_tokens"])
    for name, want in per_batch.items():
        check(launches[name] == want * n,
              f"{name}: {want * n} launches on the {arch} serve path")
    for name, shape in MAIN_SHAPES[arch].items():
        check(set(shapes[name]) == {shape}, f"{name} ran at {shape}")
    check_scan_fwd_routes(arch, launches)
    return {"launches": launches, "session": sess, "wall_s": wall,
            "stats": stats}


def check_scan_fwd_routes(arch: str, launches: dict) -> None:
    """Every SSD forward launch of a path took the warpgroup route, and
    every WKV forward launch the wgmma route."""
    from repro_torch.kernels import KERNELS
    if launches["mamba2_ssd"]:
        routes = dict(KERNELS["mamba2_ssd"].routes)
        print(f"{arch} mamba2_ssd routes: {routes}")
        check(routes == {"warpgroup": launches["mamba2_ssd"]},
              f"{arch}: every SSD forward took the warpgroup route "
              f"({routes})")
    if launches["rwkv6_wkv"]:
        routes = dict(KERNELS["rwkv6_wkv"].routes)
        print(f"{arch} rwkv6_wkv routes: {routes}")
        check(routes == {"wgmma": launches["rwkv6_wkv"]},
              f"{arch}: every WKV forward took the wgmma route ({routes})")
        WKV_WGMMA_LAUNCHES[arch] = (WKV_WGMMA_LAUNCHES.get(arch, 0)
                                    + routes["wgmma"])


# WKV forward launches on the wgmma route by arch, serve and train paths
# summed (check_scan_fwd_routes)
WKV_WGMMA_LAUNCHES = {}


def greedy(logits):
    import torch
    return torch.argmax(logits, -1)[:, None].to(torch.int32)


def profile_serve(sess, traffic: dict) -> None:
    """:func:`profile_steps` of a served session on fresh random prompts of
    the traffic's shape."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    inputs = torch.from_numpy(rng.integers(
        0, sess.cfg.vocab_size,
        (traffic["batch_size"], traffic["prompt_len"]))).cuda()
    profile_steps(traffic["arch"], sess.cfg, sess.params, sess.prefill,
                  sess.decode, {"inputs": inputs}, greedy)


def device_ms_by_range(prof) -> dict:
    """Device ms of a profiled window by the MoE layer's profiler ranges
    (``repro_torch.models.moe.RANGES``: route, dispatch, experts, combine,
    shared expert), each the kernels of the ops run inside it, read from
    the host-side range; and ``outside_moe``, the rest of the window's
    device time (attention, dense layers, norms, embedding and head)."""
    from torch.autograd import DeviceType
    from repro_torch.models.moe import RANGES
    kinds = {name: 0.0 for name in RANGES}
    for e in prof.events():
        if e.name in kinds and e.device_type == DeviceType.CPU:
            kinds[e.name] += e.device_time_total / 1e3
    kinds["outside_moe"] = (sum(r[2] for r in device_rows(prof))
                            - sum(kinds.values()))
    return kinds


def profile_steps(label: str, cfg, params, prefill_step, decode_step,
                  batch: dict, next_input, steps: int = 4) -> None:
    """One more full-width prefill, then ``steps`` decode steps (each fed
    ``next_input(logits)``), each under ``torch.profiler``: device time by
    kernel and by kind, with experts by the MoE layer's profiler ranges
    too (:func:`device_ms_by_range`), the device's busy share of the wall
    time (profiler overhead included) and device ops per decoded token.
    Their launches are not counted: the path's counts were read before."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import _merge_cache
    from repro_torch.models import transformer
    B, S = batch["inputs"].shape[:2]

    def prefill():
        return prefill_step(params, batch)

    logits, cache = prefill()                                 # warm
    state = {"full": _merge_cache(transformer.init_cache(
        cfg, B, S + steps, "cuda"), cache), "tok": next_input(logits)}

    def decode():
        for _ in range(steps):
            logits, state["full"] = decode_step(params, state["tok"],
                                                state["full"])
            state["tok"] = next_input(logits)

    torch.cuda.synchronize()
    for phase, fn, n in (("prefill", prefill, 1), ("decode", decode, steps)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = device_rows(prof)
        busy = sum(r[2] for r in rows)
        kinds = {}
        for key, count, ms in rows:
            kind = ("flash_attention" if "flash_fwd" in key else
                    "mamba2_ssd" if any(f"ssd_{r}kernel" in key for r in (
                        "", "tc_", "wg_")) else
                    "rwkv6_wkv" if any(f"wkv_{r}kernel" in key for r in (
                        "", "tc_", "wg_")) else
                    "matmul" if any(w in key.lower() for w in (
                        "nvjet", "gemm", "gemv", "cutlass", "xmma", "sm90_"))
                    else "other")
            kinds[kind] = kinds.get(kind, 0.0) + ms
        print(f"profiled {label} {phase}: wall_ms={wall * 1e3 / n} "
              f"per call, device_busy_ms={busy / n} per call, busy_share="
              f"{busy / 1e3 / wall}, device ops per call "
              f"{sum(r[1] for r in rows) / n}, device ms by kind per call: "
              f"{ {k: v / n for k, v in kinds.items()} }")
        if cfg.n_experts:
            by_range = {k: v / n for k, v in device_ms_by_range(prof).items()}
            print(f"profiled {label} {phase}: device ms by MoE range per "
                  f"call: {by_range}")
            check(by_range["moe_experts"] > 0,
                  f"{label} {phase}: the MoE ranges hold device time")
        for key, count, ms in rows[:12]:
            print(f"  device {ms:.3f} ms  x{count}  {key[:90]}")


def to_cuda(tree):
    return {k: to_cuda(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


class MoeRoutes:
    """Every MoE layer's chosen experts, on the host in call order
    (``seen``). With ``pins`` set, each call takes the next pinned choice
    in place of its own (its gates its own probabilities at the pinned
    experts, renormalised) and counts the tokens whose own choice differed
    (``flips`` of ``rows``)."""

    def __init__(self):
        self.seen, self.pins = [], None
        self.next = self.flips = self.rows = 0

    def pin(self, pins: list) -> None:
        self.pins, self.next = list(pins), 0


@contextlib.contextmanager
def moe_routes(cfg, f32: bool):
    """For a configuration with experts: record every MoE layer's chosen
    experts (:class:`MoeRoutes`), computing in f32 (``COMPUTE_DTYPE``)
    when ``f32``; yields the record (nothing for the other families). In
    bf16 a rounding difference between the devices in a router's input
    flips near-tied choices (margins below the devices' probability
    difference) and moves a token's output by a whole expert, past any
    tolerance on the logits. So the MoE cross-checks run twice: in bf16
    with the card's routes pinned to the CPU's, at the model tolerance,
    and in f32 with the chosen experts compared exactly, at
    ``MOE_F32_TOL``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe, transformer
    routes = MoeRoutes()
    if not cfg.n_experts:
        yield routes
        return
    route, dtype = moe._route, transformer.COMPUTE_DTYPE

    def recorded(x2d, router, c):
        gates, experts, aux = route(x2d, router, c)
        if routes.pins is not None:
            pin = routes.pins[routes.next].to(experts.device)
            routes.next += 1
            flipped = (experts != pin).any(-1)
            routes.flips += int(flipped.sum())
            routes.rows += int(pin.shape[0])
            if bool(flipped.any()):
                probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
                g = probs.gather(1, pin)
                g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
                top1 = F.one_hot(pin[:, 0], c.n_experts).float().mean(0)
                aux = c.n_experts * torch.sum(probs.mean(0) * top1)
                gates, experts = g.to(x2d.dtype), pin
        routes.seen.append(experts.cpu())
        return gates, experts, aux
    moe._route = recorded
    if f32:
        transformer.COMPUTE_DTYPE = torch.float32
    try:
        yield routes
    finally:
        moe._route, transformer.COMPUTE_DTYPE = route, dtype


def check_routes_equal(arch: str, gpu: list, cpu: list) -> None:
    import torch
    check(len(gpu) == len(cpu) and all(torch.equal(a, b)
                                       for a, b in zip(gpu, cpu)),
          f"{arch}: the card's chosen experts equal the CPU's, layer by "
          f"layer")
    if gpu:
        print(f"{arch}: {len(gpu)} MoE routings, experts equal on the card "
              f"and the CPU")


def moe_runs(cfg) -> list:
    """(label, f32, atol, rtol) of each card-against-CPU run: bf16 at the
    model tolerance (routes pinned where there are experts), then with
    experts f32 at ``MOE_F32_TOL``."""
    runs = [("bf16", False, MODEL_ATOL, MODEL_RTOL)]
    if cfg.n_experts:
        runs.append(("f32", True, MOE_F32_TOL, MOE_F32_TOL))
    return runs


def pinned_note(routes: MoeRoutes) -> str:
    return (f", routes pinned to the CPU's ({routes.flips} of "
            f"{routes.rows} token choices of its own differed)"
            if routes.rows else "")


def cross_check_serve(arch: str) -> None:
    """The smoke configuration on the card against the CPU, with the same
    weights (drawn once on the CPU, copied to the card), at a prompt length
    of 100 (a ragged last tile for the flash kernel, chunk 50 for SSD and
    WKV), in bf16 at the model tolerance. With experts the bf16 run pins
    the card's routes to the CPU's, and a second run in f32 compares the
    chosen experts exactly and the logits within ``MOE_F32_TOL``
    (:func:`moe_routes`)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.config import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch, smoke=True)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 100))
    for label, f32, atol, rtol in moe_runs(cfg):
        with moe_routes(cfg, f32) as routes:
            params = init_params(cfg, 0, torch.float32 if f32
                                 else torch.bfloat16, "cpu")
            cpu = ServeSession(arch, smoke=True, device="cpu", params=params)
            gpu = ServeSession(arch, smoke=True, device="cuda",
                               params=to_cuda(params))
            lc, _ = cpu.prefill(cpu.params,
                                {"inputs": torch.from_numpy(prompts)})
            n = len(routes.seen)
            if not f32:
                routes.pin(routes.seen[:n])
            lg, _ = gpu.prefill(gpu.params, {"inputs": torch.from_numpy(
                prompts).cuda()})
            note = pinned_note(routes)
            routes.pins = None
            if f32:
                check_routes_equal(arch, routes.seen[n:], routes.seen[:n])
            lg, lc = lg.float().cpu(), lc.float()
            diff = float((lg - lc).abs().max())
            excess = float(((lg - lc).abs() - rtol * lc.abs()).max())
            check(bool(torch.isfinite(lg).all()),
                  f"{arch} smoke cuda logits finite")
            check(excess <= atol, f"{arch} smoke prefill logits cuda vs "
                                  f"cpu ({label}) within atol {atol} / "
                                  f"rtol {rtol} (worst excess {excess})")
            tg = gpu.generate(prompts, 8)
            tc = cpu.generate(prompts, 8)
        print(f"serve cross-check {arch} (smoke, cuda vs cpu, {label}"
              f"{note}): prefill logits max abs diff {diff}; greedy tokens "
              f"equal {float((tg == tc).mean())}")


def serve_phase(traffic: dict, smoke_arch: str = None) -> dict:
    """The serve path of one model, its profile and its smoke cross-check
    (of ``smoke_arch``'s smoke configuration, by default the traffic's
    arch); returns the launches of the path's kernels. Nothing of the
    phase outlives it, so the next phase's peak memory is its own."""
    serve_path = run_serve_path(traffic)
    sess = serve_path["session"]
    profile_serve(sess, traffic)
    cross_check_serve(smoke_arch or traffic["arch"])
    return {name: serve_path["launches"][name]
            for name, want in per_batch_launches(sess.cfg).items() if want}


# --------------------------------------------------------------------------- #
# The vlm and audio families at full width, on embeddings
# --------------------------------------------------------------------------- #

def embedding_batch(cfg, batch: int, seq: int, steps: int, seed: int,
                    device: str = "cuda"):
    """Seeded bf16 frame or patch embeddings (B, S, d_model) drawn on
    ``device``, with (B, 3, S) M-RoPE position streams (random, distinct)
    for qwen2-vl; and ``steps`` (B, 1, d_model) decode inputs."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)

    out = {"inputs": draw(batch, seq, cfg.d_model)}
    if cfg.rope_variant == "mrope":
        out["positions"] = torch.randint(0, 4 * seq, (batch, 3, seq),
                                         generator=gen, device=device,
                                         dtype=torch.int32)
    return out, [draw(batch, 1, cfg.d_model) for _ in range(steps)]


def run_embed_path(run: dict) -> dict:
    """One prefill of ``batch_size`` x ``prompt_len`` embeddings and
    ``decode_steps`` decode steps through the step functions, with random
    weights drawn on the card at the published widths; then its profile.
    Gates: finite logits of the right shape, and exactly one
    ``flash_attention`` launch a layer at the path's shape and no other
    kernel."""
    import torch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve
    from repro_torch.launch.serve import _merge_cache
    from repro_torch.models import steps, transformer
    from repro_torch.models.config import get_config
    arch = run["arch"]
    cfg = get_config(arch)
    B, S, n = run["batch_size"], run["prompt_len"], run["decode_steps"]
    release_sessions()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, 0, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    batch, tokens = embedding_batch(cfg, B, S, n, seed=0)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    prefill_finite = bool(torch.isfinite(logits).all())
    t1 = time.perf_counter()
    full = _merge_cache(transformer.init_cache(cfg, B, S + n, "cuda"), cache)
    decode_finite = torch.ones((), dtype=torch.bool, device="cuda")
    for tok in tokens:
        logits, full = decode(params, tok, full)
        decode_finite &= torch.isfinite(logits).all()
    decode_finite = bool(decode_finite)
    t2 = time.perf_counter()
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    shapes = {k: dict(fn.shapes) for k, fn in KERNELS.items()}
    print(f"{arch} on embeddings {run}: prefill_s={t1 - t0} "
          f"decode_s_per_token={(t2 - t1) / n} weights build seconds="
          f"{build_s}")
    print(f"max_memory_allocated bytes: {torch.cuda.max_memory_allocated()} "
          f"(held before the phase: {held})")
    print(f"{arch} path launches: {launches}, shapes: "
          f"{ {k: {str(s): c for s, c in v.items()} for k, v in shapes.items()} }")
    check(prefill_finite and decode_finite, f"{arch} logits finite")
    check(tuple(logits.shape) == (B, cfg.vocab_size),
          f"{arch} logits shape {tuple(logits.shape)}")
    check(full["length"] == S + n, f"{arch} cache length")
    for name, want in per_batch_launches(cfg).items():
        check(launches[name] == want, f"{name}: {want} launches on the "
                                      f"{arch} path (got {launches[name]})")
    check_norm_routes(arch, cfg, launches["rms_norm"],
                      dict(KERNELS["rms_norm"].routes),
                      norm_launches_per_prefill(cfg) * (1 + n))
    for name, shape in MAIN_SHAPES[arch].items():
        check(set(shapes[name]) == {shape}, f"{name} ran at {shape}")
    profile_steps(arch, cfg, params, prefill, decode, batch,
                  lambda logits: tokens[0])
    return {name: launches[name]
            for name, want in per_batch_launches(cfg).items() if want}


def cross_check_embed(arch: str) -> None:
    """The smoke configuration's prefill on 4 x 100 embeddings (M-RoPE
    streams for qwen2-vl) on the card against the CPU, with the same
    weights and inputs, drawn once on the CPU."""
    import torch
    from repro_torch.models import steps
    from repro_torch.models.config import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, 0, torch.bfloat16, "cpu")
    batch, _ = embedding_batch(cfg, 4, 100, 0, seed=7, device="cpu")
    prefill = steps.make_prefill_step(cfg)
    lc, _ = prefill(params, batch)
    lg, _ = prefill(to_cuda(params), to_cuda(batch))
    lg = lg.cpu()
    excess = float(((lg - lc).abs() - MODEL_RTOL * lc.abs()).max())
    print(f"{arch} cross-check (smoke, cuda vs cpu, embeddings): prefill "
          f"logits max abs diff {float((lg - lc).abs().max())}")
    check(bool(torch.isfinite(lg).all()), f"{arch} smoke cuda logits finite")
    check(excess <= MODEL_ATOL, f"{arch} smoke prefill logits cuda vs cpu "
                                f"within atol {MODEL_ATOL} / rtol "
                                f"{MODEL_RTOL} (worst excess {excess})")


def embed_phase(run: dict) -> dict:
    launches = run_embed_path(run)
    cross_check_embed(run["arch"])
    return launches


# --------------------------------------------------------------------------- #
# Phase 7: the MoE family at full width, its depth cut
# --------------------------------------------------------------------------- #

def register_moe_cuts() -> None:
    """Each of ``MOE_CUTS``: its base's published configuration with the
    depth cut, registered under its own name (its smoke configuration is
    the base's), as :func:`register_zamba_cut` does; its parameter count,
    bf16 bytes and active count beside the full configuration's."""
    from repro_torch.models.config import get_config, register_arch
    for cut in MOE_CUTS:
        full = get_config(cut["base"])
        cfg = full.replace(name=cut["name"], n_layers=cut["n_layers"])
        register_arch(cut["name"], lambda cfg=cfg: cfg,
                      lambda base=cut["base"]: get_config(base, smoke=True))
        n = cfg.n_params()
        check(n == cut["params"], f"{cut['name']}: {cut['params']} "
                                  f"parameters (got {n})")
        print(f"{cut['name']}: {cut['base']} at full width (d "
              f"{cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, {cfg.n_experts} experts of d_ff "
              f"{cfg.d_ff}, top-{cfg.experts_per_token}, MoE every "
              f"{cfg.moe_layer_period}, shared expert "
              f"{cfg.moe_shared_expert}), depth cut to {cfg.n_layers} of "
              f"{full.n_layers} layers: {n} parameters ({2 * n} bytes in "
              f"bf16) of {full.n_params()}, {cfg.n_active_params()} active "
              f"of {full.n_active_params()}")


def moe_phase() -> dict:
    """Phase 7: each MoE cut served with ``SERVE``'s traffic after
    :func:`release_all` (so its peak is its own), its profile with the
    device time by MoE range, and its base's smoke configuration
    on the card against the CPU; returns each path's launches."""
    t0 = time.perf_counter()
    register_moe_cuts()
    paths = {}
    for traffic, cut in zip(MOE_SERVES, MOE_CUTS):
        release_all()
        paths[traffic["arch"]] = serve_phase(traffic, smoke_arch=cut["base"])
    release_sessions()
    print(f"moe phase seconds: {time.perf_counter() - t0}")
    return paths


# --------------------------------------------------------------------------- #
# Phase 8: training
# --------------------------------------------------------------------------- #

def release_all() -> None:
    """Drop the served models, the AnEn datasets and the sharded tier's
    link graphs, so that the training phase's peak memory is its own."""
    import gc
    import torch
    from repro_torch.apps.anen import workflow as wf
    from repro_torch.fusion import engine
    release_sessions()
    wf._DATASETS.clear()
    engine.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()


def train_launches_per_step(cfg) -> dict:
    """Kernel launches of one train step with one checkpoint a layer, by
    kernel, from the configuration: each attention application's flash
    forward twice (the pass and its recomputation) and its backward once;
    each Mamba-2 (hybrid) or RWKV (ssm) layer's scan forward twice and its
    backward once; no other kernel."""
    from repro_torch.kernels import KERNELS
    L = cfg.n_layers
    attn = {"ssm": 0, "hybrid": L // max(1, cfg.attn_every)}.get(
        cfg.family, L)
    scan = {"ssm": "rwkv6_wkv", "hybrid": "mamba2_ssd"}.get(cfg.family)
    want = {name: 0 for name in KERNELS}
    want.update(flash_attention=2 * attn, flash_attention_bwd=attn)
    if scan:
        want.update({scan: 2 * L, f"{scan}_bwd": L})
    return want


def register_zamba_cut() -> None:
    """zamba2-7b's published configuration with its depth cut to
    ``ZAMBA_CUT["n_layers"]`` layers, registered under its own name (its
    smoke configuration is zamba2-7b's), as
    ``examples/torch_train_ensemble.py`` registers its model."""
    from repro_torch.models.config import get_config, register_arch
    full = get_config(ZAMBA_CUT["base"])
    cut = full.replace(name=ZAMBA_CUT["name"], n_layers=ZAMBA_CUT["n_layers"])
    check(cut.n_layers % cut.attn_every == 3
          and cut.n_layers // cut.attn_every == 7,
          "the cut keeps 7 groups of attn_every layers and 3 trailing")
    register_arch(ZAMBA_CUT["name"], lambda: cut,
                  lambda: get_config(ZAMBA_CUT["base"], smoke=True))
    print(f"{ZAMBA_CUT['name']}: zamba2-7b at full width (d {cut.d_model}, "
          f"{cut.ssm_heads} SSD heads of {cut.ssm_head_dim}, state "
          f"{cut.ssm_state}, shared block {cut.n_heads} x "
          f"{cut.resolved_head_dim}), depth cut to {cut.n_layers} of "
          f"{full.n_layers} layers: {cut.n_params()} parameters of "
          f"{full.n_params()}")


def profile_train_step(sess) -> None:
    """One more step under ``torch.profiler``: device busy share of the
    step's wall time (profiler overhead included), device ms by kind and
    the leading device ops. Its launches are not counted: the path's
    counts were read before."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run_steps(1, save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[2] for r in rows)
    kinds = {}
    for key, count, ms in rows:
        kind = ("flash_attention_bwd" if bwd_part(key) else
                "flash_attention" if "flash_fwd" in key else
                "mamba2_ssd_bwd" if "ssd_bwd" in key else
                "rwkv6_wkv_bwd" if "wkv_bwd" in key else
                "mamba2_ssd" if "ssd_" in key else
                "rwkv6_wkv" if "wkv_" in key else
                "matmul" if any(w in key.lower() for w in (
                    "nvjet", "gemm", "gemv", "cutlass", "xmma", "sm90_"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print(f"profiled train step {sess.cfg.name}: wall_ms={wall * 1e3} "
          f"device_busy_ms={busy} busy_share={busy / 1e3 / wall} device "
          f"ops {sum(r[1] for r in rows)}, device ms by kind: {kinds}")
    for key, count, ms in rows[:12]:
        print(f"  device {ms:.3f} ms  x{count}  {key[:90]}")


def run_train_path(run: dict) -> tuple:
    """One model at full width through ``TrainSession``: f32 masters,
    AdamW moments, ``run["steps"]`` steps of global_batch x seq_len on the
    synthetic stream. Gates: finite losses and grad norms, exactly
    ``train_launches_per_step`` launches of every kernel a step (none of
    the others), each at the run's shape in ``TRAIN_SHAPES``. Prints peak
    bytes, warm step seconds and tokens a second, and profiles one more
    step. Returns the path's launches and its backward kernels' shapes."""
    import torch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.train import TrainSession
    arch = run["arch"]
    release_all()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = TrainSession(arch=arch, smoke=False, seq_len=run["seq_len"],
                        global_batch=run["global_batch"], device="cuda")
    sess.restore_or_init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = run["steps"]
    reset_counts()
    out = sess.run_steps(n, save=False)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    shapes = {k: dict(fn.shapes) for k, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    per_step = train_launches_per_step(sess.cfg)
    tokens = run["seq_len"] * run["global_batch"]
    print(f"train {run}: {sess.cfg.n_params()} parameters, init seconds "
          f"{init_s}, result {out}")
    print(f"max_memory_allocated bytes: {peak} (held before the phase: "
          f"{held})")
    print(f"train path launches: {launches}, shapes: "
          f"{ {k: {str(s): c for s, c in v.items()} for k, v in shapes.items()} }")
    for rec in sess.stats:
        print(f"  step {rec['step']}: loss={rec['loss']} grad_norm="
              f"{rec['grad_norm']} seconds={rec['seconds']} tokens_per_s="
              f"{tokens / rec['seconds']} launches="
              f"{ {k: rec[k + '_launches'] for k, w in per_step.items() if w} }")
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"train step {rec['step']}: finite loss and grad norm")
        for name, want in per_step.items():
            check(rec[f"{name}_launches"] == want,
                  f"{arch} {name}: {want} launches a train step (got "
                  f"{rec[name + '_launches']})")
    for name, want in per_step.items():
        check(launches[name] == want * n,
              f"{arch} {name}: {want * n} launches on the train path")
    for name, shape in TRAIN_SHAPES[arch].items():
        check(set(shapes[name]) == {shape}, f"{arch} {name} ran at {shape}")
    check_scan_fwd_routes(arch, launches)
    ssd_routes = dict(KERNELS["mamba2_ssd_bwd"].routes)
    if launches["mamba2_ssd_bwd"]:
        print(f"{arch} mamba2_ssd_bwd routes: {ssd_routes}")
        check(ssd_routes == {"cluster": launches["mamba2_ssd_bwd"]},
              f"{arch}: every SSD backward took the cluster route "
              f"({ssd_routes})")
    wkv_routes = dict(KERNELS["rwkv6_wkv_bwd"].routes)
    if launches["rwkv6_wkv_bwd"]:
        print(f"{arch} rwkv6_wkv_bwd routes: {wkv_routes}")
        check(wkv_routes == {"wgmma": launches["rwkv6_wkv_bwd"]},
              f"{arch}: every WKV backward took the wgmma route "
              f"({wkv_routes})")
    warm = [rec["seconds"] for rec in sess.stats[1:]]
    print(f"train {arch} warm step seconds {warm}, tokens a second "
          f"{[tokens / w for w in warm]}, peak bytes {peak}")
    profile_train_step(sess)
    sess.state = None
    release_all()
    return ({k: launches[k] for k, want in per_step.items() if want},
            {k: shapes[k] for k, want in per_step.items()
             if want and k.endswith("_bwd")})


def cross_check_train(arch: str) -> None:
    """One train step of the smoke configuration on the card and on the
    CPU from the same f32 train state (drawn once on the CPU) and batch (4
    x 100 from the data stream: a ragged last flash tile). bf16 compute
    differs between the two in summation order: the loss is held at the
    model tolerance, the grad norm at rtol 0.05, and the moments m̂ and √v̂
    (the clipped gradient and its magnitude at step 1) leaf by leaf at a
    normwise rtol 0.05 (bf16 against f32 compute on the CPU differs by at
    most 0.02 a leaf in these configurations). Step 1 moves each
    parameter by about ±lr = 3e-6, below any tolerance on the parameters
    themselves, so on each side every parameter is held to the update
    its own moments give, within two f32 spacings
    (``tests/_torch_update.py``). With experts the bf16 step pins the
    card's routes to the CPU's, and a second step in f32 compares the
    chosen experts exactly and loss, grad norm and moments within
    ``MOE_F32_TOL`` (:func:`moe_routes`)."""
    import torch
    from repro_torch.data import make_stream
    from repro_torch.models import steps
    from repro_torch.models.config import get_config
    sys.path.insert(0, os.path.join(HERE, "tests"))
    # the card test's checks of one AdamW step
    from _torch_update import clone_tree, moments_rel_err, update_err
    cfg = get_config(arch, smoke=True)
    batch = {k: torch.from_numpy(v)
             for k, v in make_stream(cfg, 100, 4).batch(0).items()}
    step = steps.make_train_step(cfg)
    for label, f32, atol, rtol in moe_runs(cfg):
        cpu = steps.init_train_state(cfg, 0, "cpu")
        gpu = to_cuda(cpu)
        before = clone_tree(cpu["params"])
        with moe_routes(cfg, f32) as routes:
            cpu, mc = step(cpu, batch)
            n = len(routes.seen)
            if not f32:
                routes.pin(routes.seen[:n])
            gpu, mg = step(gpu, to_cuda(batch))
            note = pinned_note(routes)
        if f32:
            check_routes_equal(arch, routes.seen[n:], routes.seen[:n])
        lg, lc = float(mg["loss"]), float(mc["loss"])
        ng, nc = float(mg["grad_norm"]), float(mc["grad_norm"])
        m_err = moments_rel_err(gpu["opt"], cpu["opt"])
        u_gpu = update_err(before, gpu["params"], gpu["opt"],
                           float(mg["lr"]))
        u_cpu = update_err(before, cpu["params"], cpu["opt"],
                           float(mc["lr"]))
        moved = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(steps.leaves(gpu["params"]),
                                    steps.leaves(before)))
        print(f"train cross-check {arch} (smoke, cuda vs cpu, {label}"
              f"{note}): loss {lg} vs {lc}, grad norm {ng} vs {nc}, moments "
              f"leaf-wise rel err {m_err}, update err (tolerances) cuda "
              f"{u_gpu} cpu {u_cpu}, largest move {moved} (lr "
              f"{float(mg['lr'])})")
        check(math.isfinite(lg) and math.isfinite(ng), f"{arch} finite")
        check(abs(lg - lc) <= atol + rtol * abs(lc),
              f"{arch} train loss cuda vs cpu ({label}) within atol {atol} "
              f"/ rtol {rtol}")
        check(abs(ng - nc) <= rtol * abs(nc),
              f"{arch} grad norm cuda vs cpu ({label}) within rtol {rtol}")
        check(int(gpu["opt"]["step"]) == int(cpu["opt"]["step"]) == 1,
              f"{arch} one step on each side")
        check(m_err <= rtol,
              f"{arch} moments cuda vs cpu ({label}) leaf by leaf within "
              f"rtol {rtol}")
        check(u_gpu <= 1.0 and u_cpu <= 1.0,
              f"{arch} every parameter written from its own moments")


def run_managed_train() -> dict:
    """minitron-4b's smoke configuration (the CLI's default architecture)
    through ``run_managed`` on ``TorchRTS``: 20 steps in chunks of 5 with
    ``fail_once_at=5``. Gates: all tasks DONE, exactly one retry, the final
    step 20, no step trained twice, and flash launches 2 x layers x steps
    forward and layers x steps backward."""
    import shutil
    import tempfile
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train
    from repro_torch.models.config import get_config
    arch = TRAIN_MANAGED["arch"]
    cfg = get_config(arch, smoke=True)
    per_step = train_launches_per_step(cfg)
    n = TRAIN_MANAGED["total_steps"]
    ckpt = tempfile.mkdtemp(prefix="train-managed-", dir=os.path.join(
        HERE, "build"))
    try:
        train._SESSIONS.clear()
        reset_counts()
        t0 = time.perf_counter()
        amgr = train.run_managed(
            arch, smoke=True, total_steps=n,
            steps_per_chunk=TRAIN_MANAGED["steps_per_chunk"], ckpt_dir=ckpt,
            fail_once_at=TRAIN_MANAGED["fail_once_at"], timeout=600.0,
            device="cuda")
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        shapes = {k: dict(fn.shapes) for k, fn in KERNELS.items()}
        tasks = [t for p in amgr.workflow for s in p.stages for t in s.tasks]
        results = [t.result for t in tasks]
        sess = train.get_session(ckpt)
        trained = [rec["step"] for rec in sess.stats]
        print(f"managed train {TRAIN_MANAGED}: all_done={amgr.all_done} "
              f"wall_s={wall} retries={[t.retries for t in tasks]} "
              f"results={results} launches={launches}")
        check(amgr.all_done, "managed train: all tasks DONE")
        check(sum(t.retries for t in tasks) == 1,
              "managed train: exactly one retry")
        check(results[-1]["step"] == n and sess.ckpt.latest() == n,
              f"managed train: final step {n}")
        check(trained == list(range(n)), "managed train: no step trained "
                                         "twice")
        check([r["first_step"] for r in results[1:]]
              == [r["step"] for r in results[:-1]],
              "managed train: each chunk resumes where the last ended")
        for name, want in per_step.items():
            check(launches[name] == want * n,
                  f"managed train: {name} {want * n} launches (got "
                  f"{launches[name]})")
        # the shape both flash kernels were held at before the paths ran
        for name in ("flash_attention", "flash_attention_bwd"):
            check(set(shapes[name]) == {FLASH_MANAGED_TRAIN},
                  f"managed train: {name} ran at {FLASH_MANAGED_TRAIN} "
                  f"(got {sorted(shapes[name])})")
        return ({k: launches[k] for k, want in per_step.items() if want},
                {"flash_attention_bwd": shapes["flash_attention_bwd"]})
    finally:
        train._SESSIONS.clear()
        shutil.rmtree(ckpt, ignore_errors=True)


def train_phase():
    """Phase 8: the full-width train runs with their profiles, the smoke
    configurations card against CPU, and the managed run; returns the
    launches of each path and the backward kernels' shapes on each."""
    t0 = time.perf_counter()
    register_zamba_cut()
    paths, shapes = {}, {}
    for run in TRAIN_RUNS:
        label = f"train {run['arch']}"
        paths[label], shapes[label] = run_train_path(run)
    for arch in TRAIN_SMOKE:
        cross_check_train(arch)
    managed = f"train {TRAIN_MANAGED['arch']} managed"
    paths[managed], shapes[managed] = run_managed_train()
    print(f"train phase seconds: {time.perf_counter() - t0}")
    return paths, shapes


# phase 9: the one-device dry-run against the card. Each step's predicted
# peak memory must be within DRYRUN_PEAK_TOL of the measured one; launches
# exact; matmul FLOPs within DRYRUN_FLOP_TOL of FlopCounterMode's
DRYRUN_STEPS = (("qwen2-vl-2b", "train", 4, 512),
                ("minitron-4b", "prefill", 4, 512))
DRYRUN_PEAK_TOL = 0.15
DRYRUN_FLOP_TOL = 1e-6
# the dry-run's kernel ops by the name the wrappers count launches under
DRYRUN_OPS = {"flash_fwd": "flash_attention",
              "flash_bwd": "flash_attention_bwd",
              "ssd_fwd": "mamba2_ssd", "ssd_bwd": "mamba2_ssd_bwd",
              "wkv_fwd": "rwkv6_wkv", "wkv_bwd": "rwkv6_wkv_bwd",
              "rms_norm": "rms_norm", "add_rms_norm": "rms_norm"}


def real_inputs(cfg, shape, device):
    """Seeded inputs of the shapes and dtypes ``input_specs`` gives."""
    import torch
    from repro_torch.models.input_specs import input_specs
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {}
    for name, spec in input_specs(cfg, shape)["batch"].items():
        if spec.dtype == torch.bfloat16:
            out[name] = torch.randn(spec.shape, generator=gen,
                                    device=device).to(torch.bfloat16)
        elif name == "positions":
            pos = torch.arange(spec.shape[-1], device=device,
                               dtype=torch.int32)
            out[name] = pos.expand(spec.shape).contiguous()
        else:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=gen, device=device,
                                      dtype=torch.int32)
    return out


def dryrun_check(arch: str, kind: str, batch: int, seq: int) -> dict:
    """The one-device dry-run's prediction of one step (fake tensors on
    the card's device type), then the same step run for real: its peak
    (``max_memory_allocated`` over what was held before its state and
    inputs were built), its kernels' launches and, in a second run under
    ``FlopCounterMode``, its matmul FLOPs."""
    import torch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.dryrun import cell_record
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.op_analysis import matmul_flops_of
    from repro_torch.models import steps
    from repro_torch.models.config import ShapeConfig, get_config
    cfg = get_config(arch)
    shape = ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)
    t0 = time.perf_counter()
    rec = cell_record(arch, shape.name, Mesh(("data", "model"), (1, 1)),
                      device="cuda", cfg=cfg, shape=shape)
    predict_s = time.perf_counter() - t0
    pred = rec["memory"]["peak_bytes_per_device"]
    release_all()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    if kind == "train":
        args = (steps.init_train_state(cfg, 0, "cuda"),)
        fn = steps.make_train_step(cfg)
    else:
        args = (steps.transformer.init_params(cfg, 0, torch.float32,
                                              "cuda"),)
        fn = steps.make_prefill_step(cfg)
    args = (*args, real_inputs(cfg, shape, "cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: f.launches for k, f in KERNELS.items()}
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    launches = {k: f.launches - before[k] for k, f in KERNELS.items()}
    del out
    flops = matmul_flops_of(fn, *args)
    del args
    release_all()
    want = collections.Counter()
    for op, n in rec["launches"].items():
        want[DRYRUN_OPS[op]] += n
    want = dict(want)
    got = {k: n for k, n in launches.items() if n}
    err = abs(pred - peak) / peak
    flop_err = abs(rec["per_device"]["matmul_flops"] - flops) / flops
    row = {"arch": arch, "kind": kind, "shape": [batch, seq],
           "predicted_peak_bytes": pred, "measured_peak_bytes": peak,
           "peak_rel_err": err, "predicted_launches": want,
           "measured_launches": got,
           "predicted_matmul_flops": rec["per_device"]["matmul_flops"],
           "measured_matmul_flops": flops, "flop_rel_err": flop_err,
           "predict_s": predict_s, "trace_s": rec["trace_s"]}
    print(f"dryrun {arch} {kind} ({batch}, {seq}) on the card: {row}")
    check(err <= DRYRUN_PEAK_TOL,
          f"{arch} {kind}: predicted peak {pred} within "
          f"{DRYRUN_PEAK_TOL} of the measured {peak} (off by {err})")
    check(want == got, f"{arch} {kind}: predicted launches {want} == "
                       f"measured {got}")
    check(flop_err <= DRYRUN_FLOP_TOL,
          f"{arch} {kind}: matmul FLOPs {rec['per_device']['matmul_flops']}"
          f" within {DRYRUN_FLOP_TOL} of FlopCounterMode's {flops}")
    return row


def compression_check() -> None:
    """int8 gradient compression on the card gives the CPU's bits, and a
    smoke ``TrainSession(grad_compression="int8")`` on the card allocates
    its zero f32 error state there and trains the losses of an
    uncompressed session."""
    import torch
    from repro_torch.launch import train
    from repro_torch.optim import compression
    gen = torch.Generator().manual_seed(0)
    g = torch.randn((1 << 20) + 123, generator=gen) * 3.0
    g[:2048] *= 1e-14                  # a block at the scale's floor
    qc, sc = compression.compress_int8(g)
    qg, sg = compression.compress_int8(g.cuda())
    dc = compression.decompress_int8(qc, sc, g.shape)
    dg = compression.decompress_int8(qg, sg, g.shape)
    check(torch.equal(qg.cpu(), qc), "int8 blocks on the card == CPU's")
    check(torch.equal(sg.cpu().view(torch.int32), sc.view(torch.int32)),
          "int8 scales on the card == CPU's bits")
    check(torch.equal(dg.cpu().view(torch.int32), dc.view(torch.int32)),
          "dequantized values on the card == CPU's bits")
    kw = dict(arch="minitron-4b", smoke=True, seq_len=64, global_batch=4,
              device="cuda")
    plain = train.TrainSession(**kw)
    comp = train.TrainSession(grad_compression="int8", **kw)
    plain.run_steps(3, save=False)
    comp.run_steps(3, save=False)
    losses = [r["loss"] for r in comp.stats]
    check(losses == [r["loss"] for r in plain.stats],
          f"int8 session's losses {losses} == uncompressed "
          f"{[r['loss'] for r in plain.stats]}")
    errs = list(steps_leaves(comp.error_state))
    check(all(e.device.type == "cuda" and e.dtype == torch.float32
              and not e.any() for e in errs),
          "int8 error state: zero f32 on the card")
    print(f"int8 compression: card == CPU bits on {g.numel()} values; "
          f"smoke TrainSession(grad_compression='int8') on the card: "
          f"{len(errs)} error leaves, losses {losses}")


def steps_leaves(tree):
    from repro_torch.optim.adamw import leaves
    return leaves(tree)


def dryrun_phase() -> list:
    """Phase 9: the dry-run tier and int8 compression on the card."""
    t0 = time.perf_counter()
    rows = [dryrun_check(*step) for step in DRYRUN_STEPS]
    compression_check()
    print(f"dryrun phase seconds: {time.perf_counter() - t0}")
    return rows


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)   # a cut run keeps its log
    sys.path.insert(0, SRC)
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    build_s = build_kernels()
    print(f"kernel build seconds: {build_s}")

    equal = [compare_distance(s) for s in EQUAL_SHAPES]
    floor_ms = empty_ms()
    print(f"empty kernel device_ms (the floor under kernel times): "
          f"{floor_ms}")
    for row in [time_distance(s) for s in TIMED_SHAPES]:
        print(f"anen_distance {row}")

    main_path = run_main_path()
    # time the kernel at the shape the main path launched it at most
    main_shape = max(main_path["shapes"], key=main_path["shapes"].get)
    equal.append(compare_distance(main_shape))
    at_main = time_distance(main_shape)
    print(f"anen_distance at main-path shape {at_main}")

    cross_check()
    profile_main_path()
    service = run_service_phase()

    run_seismic_chain(SEISMIC)
    run_seismic_dag(SEISMIC)
    profile_seismic_dag(SEISMIC)
    cross_check_seismic()
    sharded = sharded_phase("lanes")
    if torch.cuda.device_count() >= 2:
        sharded["cards"] = sharded_phase("cards")
    else:
        print(f"sharded tier on distinct cards (and the compressed mean "
              f"over an NCCL group of a rank a card): not run "
              f"({torch.cuda.device_count()} device)")
    check_grad_routes()

    # the model kernels against their plain versions, main-path and ragged
    # shapes, f32 and bf16
    errors = {"flash_attention": [], "flash_attention_bwd": [],
              "mamba2_ssd": [], "mamba2_ssd_bwd": [], "rwkv6_wkv": [],
              "rwkv6_wkv_bwd": []}
    full_errors = {"flash_attention_noncausal": [],
                   "flash_attention_bwd_noncausal": []}
    for dtype in ("float32", "bfloat16"):
        for shape in FLASH_SHAPES:
            errors["flash_attention"].append(compare_flash(shape, dtype))
        for shape in FLASH_BWD_SHAPES:
            errors["flash_attention_bwd"].append(
                compare_flash_bwd(shape, dtype))
        for shape in SSD_SHAPES:
            errors["mamba2_ssd"].append(compare_ssd(shape, dtype))
        for shape in WKV_SHAPES:
            errors["rwkv6_wkv"].append(compare_wkv(shape, dtype))
        if dtype == "bfloat16":
            for shape in WKV_CLAMPED:
                errors["rwkv6_wkv"].append(
                    compare_wkv(shape, dtype, clamped=True))
        for shape in SSD_BWD_SHAPES:
            errors["mamba2_ssd_bwd"].append(
                compare_scan_bwd("mamba2_ssd", shape, dtype))
        for shape in WKV_BWD_SHAPES:
            errors["rwkv6_wkv_bwd"].append(
                compare_scan_bwd("rwkv6_wkv", shape, dtype))
        for shape in WKV_BWD_CLAMPED:
            errors["rwkv6_wkv_bwd"].append(
                compare_scan_bwd("rwkv6_wkv", shape, dtype, clamped=True))
        if dtype == "bfloat16":
            # the wgmma route, also without a final-state gradient
            for shape in WKV_BWD_WGMMA[1:]:
                errors["rwkv6_wkv_bwd"].append(
                    compare_scan_bwd("rwkv6_wkv", shape, dtype))
            for shape in (*WKV_BWD_WGMMA, *WKV_BWD_CLAMPED):
                errors["rwkv6_wkv_bwd"].append(compare_scan_bwd(
                    "rwkv6_wkv", shape, dtype,
                    clamped=shape in WKV_BWD_CLAMPED, with_dstate=False))
        for shape in FLASH_FULL_SHAPES:
            full_errors["flash_attention_noncausal"].append(
                compare_flash(shape, dtype, causal=False))
        for shape in FLASH_FULL_BWD_SHAPES[dtype]:
            full_errors["flash_attention_bwd_noncausal"].append(
                compare_flash_bwd(shape, dtype, causal=False))
    errors["flash_attention"].append(
        compare_flash_unaligned(FLASH_UNALIGNED, causal=True))
    full_errors["flash_attention_noncausal"].append(
        compare_flash_unaligned(FLASH_UNALIGNED, causal=False))
    errors["flash_attention_bwd"].append(
        compare_flash_bwd_unaligned(FLASH_UNALIGNED, causal=True))
    full_errors["flash_attention_bwd_noncausal"].append(
        compare_flash_bwd_unaligned(FLASH_UNALIGNED, causal=False))
    compiled = compiled_kernels(main_shape[2])
    norm = check_norm()
    full_compiled = compiled_full_kernels()
    fwd_compiled = compiled_forward_kernels()
    bwd_compiled = compiled_backward_kernels()
    timed = {"flash_attention": time_flash(FLASH_MAIN),
             "flash_attention_bwd": time_flash_bwd(FLASH_BWD_TIMED[0]),
             "mamba2_ssd": time_ssd(SSD_MAIN),
             "mamba2_ssd_bwd": time_scan_bwd("mamba2_ssd", SSD_MAIN),
             "rwkv6_wkv": time_wkv(WKV_MAIN),
             "rwkv6_wkv_bwd": time_scan_bwd("rwkv6_wkv", WKV_MAIN)}
    bwd_more = [time_flash_bwd(shape) for shape in FLASH_BWD_TIMED[1:]]
    wkv_f32 = time_wkv(WKV_MAIN, "float32")
    flash_more = [time_flash(shape) for shape in FLASH_TIMED]
    for name, row in timed.items():
        print(f"{name} at main-path shape {row}")
    print(f"rwkv6_wkv f32 route at main-path shape {wkv_f32}")
    for row in flash_more:
        print(f"flash_attention at {tuple(row['shape'])} {row}")
    for row in bwd_more:
        print(f"flash_attention_bwd at {tuple(row['shape'])} {row}")
    full_timed = {"flash_attention_noncausal":
                  [time_flash(shape, causal=False)
                   for shape in FLASH_FULL_TIMED],
                  "flash_attention_bwd_noncausal":
                  [time_flash_bwd(shape, causal=False)
                   for shape in FLASH_FULL_BWD_TIMED]}
    for name, rows in full_timed.items():
        for row in rows:
            print(f"{name} at {tuple(row['shape'])} {row}")
    full_launches = run_noncausal_path()

    # every serve path with its counts at 0 just before it and read after
    by_path = {}
    for traffic in (SERVE, RWKV_SERVE, *DENSE_SERVES):
        by_path[traffic["arch"]] = serve_phase(traffic)
    for run in EMBED_RUNS:
        by_path[run["arch"]] = embed_phase(run)
    by_path.update(moe_phase())
    train_paths, bwd_shapes = train_phase()
    by_path.update(train_paths)
    dryrun_rows = dryrun_phase()
    launches = {name: sum(path.get(name, 0) for path in by_path.values())
                for name in timed}
    print(f"model kernel launches by path: {by_path}")
    print(f"rwkv6_wkv launches on the wgmma route by path: "
          f"{WKV_WGMMA_LAUNCHES}")
    check(launches["rwkv6_wkv"] > 0
          and sum(WKV_WGMMA_LAUNCHES.values()) == launches["rwkv6_wkv"],
          f"all {launches['rwkv6_wkv']} WKV forwards of the main paths took "
          f"the wgmma route ({WKV_WGMMA_LAUNCHES})")

    record = {"kernels": [{
        "name": "anen_distance",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/anen_distance.cu",
        "replaces": "src/repro/kernels/anen_distance.py:81",
        "launches": main_path["launches"],
        "service_launches": service["launches"],
        "service_shapes": {str(k): v for k, v in service["shapes"].items()},
        "max_abs_err": max(r["max_abs_err"] for r in equal),
        "ms": at_main["ms"],
        "plain_ms": at_main["plain_ms"],
        "call_ms": at_main["call_ms"],
        "bound_ms": at_main["bound_ms"],
        "bound_by": at_main["bound_by"],
        "library_ms": None,
        "shape": at_main["shape"],
        "empty_kernel_ms": floor_ms,
    }]}
    b2 = next(r for r in sharded["rows"]
              if r["places"] == SHARDED_LANES
              and tuple(r["shape"]) == ANEN_MAIN_SHAPE)
    record["kernels"].append({
        "name": "anen_distance_sharded",
        "route": "cuda",
        # B1's kernel once a place: the wrapper has no source of its own
        "source": "src/repro_torch/kernels/csrc/anen_distance.cu",
        "wrapper": "src/repro_torch/kernels/anen_distance.py",
        "replaces": "src/repro/kernels/anen_distance.py:97",
        "places": SHARDED_LANES,
        "places_are": "lanes of one card (virtual devices)",
        # B1 launches of the sharded AnEn path: one a lane a dispatch
        "launches": sharded["anen"]["launches"],
        "shapes": {str(k): v for k, v in sharded["anen"]["shapes"].items()},
        "max_abs_err": max(r["max_abs_err"] for r in sharded["rows"]),
        "ms": b2["ms"],
        "plain_ms": b2["plain_ms"],
        "call_ms": b2["call_ms"],
        "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"],
        "library_ms": None,
        "shape": b2["shape"],
        "shard_shape": b2["shard_shape"],
        "shard_ms": b2["shard_ms"],
        "shard_bound_ms": b2["shard_bound_ms"],
        "b1_ms": b2["b1_ms"],
        "distinct_cards": "cards" in sharded,
    })
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:103",
                "flash_attention_bwd":
                    "src/repro/kernels/flash_attention.py:153",
                "mamba2_ssd": "src/repro/kernels/mamba2_ssd.py:106",
                # no TPU backward kernel: the JAX package trains through
                # jax.grad of these chunked scans
                "mamba2_ssd_bwd": "src/repro/models/mamba2.py:74",
                "rwkv6_wkv": "src/repro/kernels/rwkv6_wkv.py:109",
                "rwkv6_wkv_bwd": "src/repro/models/rwkv6.py:85"}
    for name, row in timed.items():
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "launches_by_path": {arch: path[name]
                                 for arch, path in by_path.items()
                                 if name in path},
            "max_abs_err": max(errors[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "call_ms": row["call_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"]})
        if "library_busy_ms" in row:
            record["kernels"][-1]["library_busy_ms"] = row["library_busy_ms"]
    flash_entry = next(e for e in record["kernels"]
                       if e["name"] == "flash_attention")
    hd160 = compiled[("flash_attention", "bfloat16", 160)]
    flash_entry["route_bf16"] = timed["flash_attention"]["route"]
    flash_entry["other_shapes"] = [
        {k: row[k] for k in ("shape", "route", "ms", "busy_ms", "plain_ms",
                             "library_ms", "library_busy_ms", "call_ms",
                             "bound_ms", "bound_by")} for row in flash_more]
    flash_entry["compiled_bf16"] = {
        f"hd {hd}": {k: row[k] for k in ("registers", "spill_bytes",
                                         "blocks_per_sm", "threads")}
        for (causal, hd), row in fwd_compiled.items() if causal}
    flash_entry["hd160_compiled"] = {
        "registers": hd160["registers"], "spill_bytes": hd160["spill_bytes"],
        "smem_bytes": hd160["static_smem_bytes"]
        + hd160["dynamic_smem_bytes"],
        "blocks_per_sm": hd160["blocks_per_sm"],
        "threads": hd160["threads"]}
    bwd_entry = next(e for e in record["kernels"]
                     if e["name"] == "flash_attention_bwd")
    for entry in record["kernels"]:
        if entry["name"].endswith("_bwd"):
            entry["shapes"] = {
                path: {str(k): v for k, v in by_kernel[entry["name"]].items()}
                for path, by_kernel in bwd_shapes.items()
                if entry["name"] in by_kernel}
    bwd_entry["parts_busy_ms"] = timed["flash_attention_bwd"][
        "parts_busy_ms"]
    bwd_entry["route_bf16"] = timed["flash_attention_bwd"]["route"]
    bwd_entry["other_shapes"] = [
        {k: row[k] for k in ("shape", "route", "ms", "busy_ms",
                             "parts_busy_ms", "plain_ms", "library_ms",
                             "library_busy_ms", "call_ms", "bound_ms",
                             "bound_by")}
        for row in bwd_more]
    bwd_entry["compiled_bf16"] = {
        f"{which} hd {hd}": {k: row[k] for k in ("route", "registers",
                                                 "spill_bytes",
                                                 "blocks_per_sm", "threads")}
        for (causal, which, hd), row in bwd_compiled.items() if causal}
    bwd_entry["compiled"] = {
        key[2]: {k: row[k] for k in ("registers", "spill_bytes",
                                     "blocks_per_sm")}
        for key, row in compiled.items()
        if key[:2] == ("flash_attention_bwd", "bfloat16") and len(key) == 3
        and "hd" in key[2]}
    for name in ("mamba2_ssd_bwd", "rwkv6_wkv_bwd"):
        entry = next(e for e in record["kernels"] if e["name"] == name)
        entry.update(
            parts_busy_ms=timed[name]["parts_busy_ms"],
            workspace_bytes=timed[name]["workspace_bytes"],
            route_bf16=timed[name]["route"],
            compiled_parts={part: {k: compiled[(name, "bfloat16", part)][k]
                                   for k in ("registers", "spill_bytes",
                                             "blocks_per_sm")}
                            for part in ("chunk", "walk")})
        if name == "mamba2_ssd_bwd":
            entry.update(max_active_clusters=compiled[
                (name, "bfloat16")]["max_active_clusters"])
    ssd_entry = next(e for e in record["kernels"]
                     if e["name"] == "mamba2_ssd")
    ssd_entry.update(
        route_bf16=timed["mamba2_ssd"]["route"],
        busy_ms=timed["mamba2_ssd"]["busy_ms"],
        compiled_mma_sync={
            k: compiled[("mamba2_ssd", "bfloat16", "mma.sync")][k]
            for k in ("registers", "spill_bytes", "blocks_per_sm")})
    wkv_entry = next(e for e in record["kernels"]
                     if e["name"] == "rwkv6_wkv")
    wkv_entry.update(
        route_bf16=timed["rwkv6_wkv"]["route"],
        busy_ms=timed["rwkv6_wkv"]["busy_ms"],
        compiled_wgmma={k: compiled[("rwkv6_wkv", "bfloat16")][k]
                        for k in ("registers", "spill_bytes",
                                  "blocks_per_sm", "threads")},
        compiled_mma={k: compiled[("rwkv6_wkv", "bfloat16", "mma")][k]
                      for k in ("registers", "spill_bytes",
                                "blocks_per_sm")},
        f32_ms=wkv_f32["ms"], f32_busy_ms=wkv_f32["busy_ms"],
        f32_plain_ms=wkv_f32["plain_ms"], f32_bound_ms=wkv_f32["bound_ms"])
    # the non-causal mode (causal=False) of the flash kernels, apart:
    # launches from its own path, times at its first timed shape
    for name, rows in full_timed.items():
        base = name[:-len("_noncausal")]
        row = rows[0]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{base}.cu",
            "replaces": replaces[base], "causal": False,
            "launches": full_launches[name],
            "max_abs_err": max(full_errors[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "call_ms": row["call_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_busy_ms": row["library_busy_ms"],
            "shape": row["shape"], "dtype": row["dtype"],
            "other_shapes": [
                {k: r[k] for k in ("shape", "route", "ms", "busy_ms",
                                   "plain_ms", "library_ms",
                                   "library_busy_ms", "call_ms", "bound_ms",
                                   "bound_by") if k in r}
                for r in rows[1:]],
            "compiled": {key: {k: info[k] for k in ("registers",
                                                   "spill_bytes",
                                                   "blocks_per_sm")}
                         for key, info in full_compiled.items()
                         if (key.startswith("forward")
                             == (base == "flash_attention"))}})
        if base == "flash_attention_bwd":
            record["kernels"][-1].update(parts_busy_ms=row["parts_busy_ms"],
                                         route_bf16=row["route"])
    timed_norms = [r for r in norm["rows"] if "ms" in r]
    record["kernels"].append({
        "name": "rms_norm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rms_norm.cu",
        # no TPU kernel: the JAX package leaves its norms to XLA
        "replaces": "src/repro/models/mlp.py:11",
        "launches": {arch: path_norms for arch, path_norms in
                     NORM_LAUNCHES.items()},
        "max_ulps": max(r["max_ulps"] for r in norm["rows"]),
        "timed": timed_norms,
        "compiled": [{k: r[k] for k in ("shape", "delta", "registers",
                                        "spill_bytes", "blocks_per_sm",
                                        "threads")}
                     for r in norm["rows"]]})
    for entry in record["kernels"]:
        info = compiled.get((entry["name"], entry.get("dtype", "float32")))
        if info is not None:
            entry.update(
                registers=info["registers"],
                spill_bytes=info["spill_bytes"],
                smem_bytes=info["static_smem_bytes"]
                + info["dynamic_smem_bytes"],
                blocks_per_sm=info["blocks_per_sm"])
    print(f"dryrun on the card: {json.dumps(dryrun_rows)}")
    print(f"profiler: {PROFILER_MISSES['empty_traces']} empty traces taken "
          f"again; busy times from CUDA events instead (every trace "
          f"empty): {PROFILER_MISSES['timed_by_events']}")
    print(f"script seconds: {time.perf_counter() - t_start}")
    print(card_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
