"""Where a chunk's time goes in the WKV backward's Hopper kernel.

    python3 tools/trace_wkv_bwd.py [--src PATH/src] [--shape B,T,H,N]

Copies ``csrc/rwkv6_wkv_bwd.cu`` of the tree into ``build/trace_wkv_bwd/``,
adds marks to its wgmma kernel (``wkv_bwd_wg_kernel``) and builds that
copy with the tree's nvcc flags (``tools/trace_marks.py``); then calls it
in bf16 at rwkv6-3b's train shape (4, 512, 40, 64), or ``--shape`` (B H <=
160, T <= 512, N = 64), as the train step does (no final-state gradient),
and prints, from the global timer (ns) that thread 0 of a block (the
products' warpgroup) reads at each mark, the phases of a backward chunk
(median and quartiles over every block's chunks), what the products'
warpgroup waits on (the pass's pre-pass, and the pass at the chunk's end),
the pass warpgroups' pre-pass and epilogue a chunk (thread 128), a
phase 1 chunk (what the products wait on, and their own work), phase 1
(the walk forwards, all chunks) and phase 2 a block, the launch's span and
the blocks' life.

The marks are stores by one thread of a block: the kernel's time shifts a
little (it prints ``device_ms`` of the marked copy beside the tree's own,
and whether their outputs agree bit for bit). Needs the card; the tree's
own kernels are not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

from trace_marks import GLOBALTIMER, HERE, build, quartiles, read, readers, \
    splice

SHAPE = (4, 512, 40, 64)
MAX_BLOCKS, MAX_CHUNKS = 4 * 40, 8
PHASES = ("dscores, dout.S^T (beside the pre-pass)", "mask, wait for the pass",
          "dr_dec += dscores.k_over, hand-off", "D' tiles",
          "dS' update, dscores^T, v.D'^T", "L-step term",
          "dscores^T.r_dec, hand-off", "scores^T, k_over.D'",
          "mask, scores^T.dout", "dv to its tile", "wait for the pass's epilogue")
N_MARKS = len(PHASES) + 1
PASS = ("pre-pass", "wait for dr_dec", "dr", "wait for dk_tot",
        "dk, dcum, scan, dw")
N_PASS = len(PASS) + 1
PHASE1 = ("wait for the pass and the loads", "S images, k_over^T.v, decay")
DEFS = f'''
__device__ unsigned long long g_marks[{MAX_BLOCKS * MAX_CHUNKS * N_MARKS}];
__device__ unsigned long long g_pass[{MAX_BLOCKS * MAX_CHUNKS * N_PASS}];
__device__ unsigned long long g_pro[{MAX_BLOCKS * 3}];
__device__ unsigned long long g_p1[{MAX_BLOCKS * MAX_CHUNKS * 3}];
#define BLOCK_ID (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x)
#define MARK(n) if (threadIdx.x == 0) {{ unsigned long long _gt; \\
  {GLOBALTIMER} g_marks[(BLOCK_ID * {MAX_CHUNKS} + i) * {N_MARKS} + (n)] \\
  = _gt; }}
#define PASSMARK(n) if (threadIdx.x == 128) {{ unsigned long long _gt; \\
  {GLOBALTIMER} g_pass[(BLOCK_ID * {MAX_CHUNKS} + i) * {N_PASS} + (n)] \\
  = _gt; }}
#define P1MARK(n) if (threadIdx.x == 0) {{ unsigned long long _gt; \\
  {GLOBALTIMER} g_p1[(BLOCK_ID * {MAX_CHUNKS} + c) * 3 + (n)] = _gt; }}
#define PMARK(n) if (threadIdx.x == 0) {{ unsigned long long _gt; \\
  {GLOBALTIMER} g_pro[BLOCK_ID * 3 + (n)] = _gt; }}
'''
# (anchor, mark, after): each anchor occurs once in csrc/rwkv6_wkv_bwd.cu
MARKS = (
    ("namespace {\n", DEFS, False),
    ("  const uint32_t bar_in2 = bar_free1 + 16;\n", "  PMARK(0)\n", True),
    ("  hp::bar_sync(kBarPhase, kThreads);   // phase 1 done\n",
     "  PMARK(1)\n", True),
    ("    hp::mbar_wait(bar_pass1 + 8 * st, (c >> 1) & 1);\n",
     "    P1MARK(0)\n", False),
    ("\n    hp::mbar_wait(bar_in1 + 8 * (c % kSlots), (c / kSlots) & 1);\n",
     "    P1MARK(1)\n", True),
    ("      if (c + kSlots < K) load1(c + kSlots);\n    }\n",
     "    P1MARK(2)\n", True),
    ("    // a. dscores = dout . v^T; dr_dec = dout . S_j^T", "    MARK(0)\n",
     False),
    ("      // ddiag = dout . v of each row: dscores' diagonal\n",
     "      MARK(1)\n", False),
    ("      hp::bar_sync(kBarPre, kThreads);   // r_dec, k_over and the "
     "vectors in\n", "      MARK(2)\n", True),
    ("      hp::bar_arrive(kBarH1, kThreads);\n", "      MARK(3)\n", True),
    ("    hp::bar_sync(kBarMma, kMmaThreads);   // D''s tiles in\n",
     "    MARK(4)\n", True),
    ("      hp::fence_regs(dS);\n      hp::fence_regs(dsc);\n",
     "      MARK(5)\n", True),
    ("      mask_tri<false>(dsc, nullptr);\n", "      MARK(6)\n", False),
    ("      hp::bar_arrive(kBarH2, kThreads);\n", "      MARK(7)\n", True),
    ("      mask_tri<false>(sc, vec + kVBonus);\n", "      MARK(8)\n",
     False),
    ("      // dv in bf16 to D''s hi tile", "      MARK(9)\n", False),
    ("    hp::bar_sync(kBarEnd, kThreads);   // the chunk's stage and "
     "hand-offs read\n", f"    MARK({N_MARKS - 2})\n", False),
    ("    if (tid == 0) {\n      hp::tma_store_4d(&tm_dv",
     f"    MARK({N_MARKS - 1})\n", False),
    ("#pragma unroll\n  for (int jj = 0; jj < 8; ++jj)\n#pragma unroll\n    "
     "for (int hh = 0; hh < 2; ++hh)\n      *reinterpret_cast<float2*>("
     "dstate0", "  PMARK(2)\n", False),
    ("      hp::mbar_wait(bar_in2 + 8 * st, (i >> 1) & 1);\n      // a. e by",
     "      PASSMARK(0)\n", False),
    ("      hp::bar_sync(kBarPre, kThreads);\n      float dd[kPassRows];",
     "      PASSMARK(1)\n", False),
    ("      hp::bar_sync(kBarH1, kThreads);\n", "      PASSMARK(2)\n", True),
    ("      // dk as dk_tot comes;", "      PASSMARK(3)\n", False),
    ("      hp::bar_sync(kBarH2, kThreads);\n", "      PASSMARK(4)\n", True),
    ("      hp::bar_sync(kBarEnd, kThreads);\n    }\n    // du's part",
     "      PASSMARK(5)\n", False),
)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(HERE, "src"))
    parser.add_argument("--shape", default=",".join(map(str, SHAPE)),
                        help="B,T,H,N (B H <= 160, T <= 512, N = 64)")
    args = parser.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import rwkv6_wkv
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    shape = tuple(int(v) for v in args.shape.split(","))
    B, T, H, N = shape
    K = T // 64
    if B * H > MAX_BLOCKS or K > MAX_CHUNKS or N != 64 or T % 64:
        raise SystemExit(f"--shape: B H <= {MAX_BLOCKS}, T <= "
                         f"{64 * MAX_CHUNKS} a multiple of 64, N = 64")
    lib = build(src, "trace_wkv_bwd", "rwkv6_wkv_bwd.cu",
                lambda text: splice(text, MARKS, "tools/trace_wkv_bwd.py")
                + readers("g_marks", "g_pass", "g_pro", "g_p1"))
    launch = lib.rwkv6_wkv_bwd_launch
    launch.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    launch.restype = ctypes.c_int

    args_, dout, _ = cs.scan_bwd_inputs("rwkv6_wkv", shape, "bfloat16")
    r, k, v, w, u, s0 = args_
    grads = [torch.empty_like(a) for a in (r, k, v, w, u, s0)]
    f32 = dict(dtype=torch.float32, device=r.device)
    work = torch.empty(B * H * K * N * N, **f32)
    du_part = torch.empty(B * H * N, **f32)

    def marked():
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), s0.data_ptr(), dout.data_ptr(), 0,
                     *(g.data_ptr() for g in grads), work.data_ptr(), 0,
                     du_part.data_ptr(), B, T, H, N, 64,
                     rwkv6_wkv.BWD_ROUTES.index("wgmma"),
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    print(cs.card_line())
    row = {"shape": list(shape), "device_ms_marked": cs.device_ms(marked),
           "device_ms_tree": cs.device_ms(
               lambda: rwkv6_wkv.rwkv6_wkv_bwd(r, k, v, w, u, s0, dout))}
    marked()
    torch.cuda.synchronize()
    want = rwkv6_wkv.rwkv6_wkv_bwd(r, k, v, w, u, s0, dout)
    row["marked_equals_tree"] = all(torch.equal(a, b)
                                    for a, b in zip(grads, want))
    marks = read(lib, "g_marks", ctypes.c_ulonglong,
                 MAX_BLOCKS * MAX_CHUNKS * N_MARKS)
    pas = read(lib, "g_pass", ctypes.c_ulonglong,
               MAX_BLOCKS * MAX_CHUNKS * N_PASS)
    pro = read(lib, "g_pro", ctypes.c_ulonglong, MAX_BLOCKS * 3)
    p1 = read(lib, "g_p1", ctypes.c_ulonglong, MAX_BLOCKS * MAX_CHUNKS * 3)
    p1at = lambda i, c: [p1[(i * MAX_CHUNKS + c) * 3 + n]  # noqa: E731
                         for n in range(3)]
    at = lambda i, c: [marks[(i * MAX_CHUNKS + c) * N_MARKS + n]  # noqa
                       for n in range(N_MARKS)]
    pat = lambda i, c: [pas[(i * MAX_CHUNKS + c) * N_PASS + n]  # noqa
                        for n in range(N_PASS)]
    blocks = range(B * H)
    chunks = [at(i, c) for i in blocks for c in range(K)]
    passes = [pat(i, c) for i in blocks for c in range(K)]
    starts = [pro[3 * i] for i in blocks]
    ends = [pro[3 * i + 2] for i in blocks]
    row.update(
        phases_ns_quartiles={
            name: quartiles([ch[n + 1] - ch[n] for ch in chunks])
            for n, name in enumerate(PHASES)},
        chunk_ns_quartiles=quartiles([ch[-1] - ch[0] for ch in chunks]),
        pass_ns_quartiles={
            name: quartiles([p[n + 1] - p[n] for p in passes])
            for n, name in enumerate(PASS)},
        phase1_chunk_ns_quartiles={
            name: quartiles([p1at(i, c)[n + 1] - p1at(i, c)[n]
                             for i in blocks for c in range(K)])
            for n, name in enumerate(PHASE1)},
        phase1_ns_quartiles=quartiles(
            [pro[3 * i + 1] - pro[3 * i] for i in blocks]),
        phase2_ns_quartiles=quartiles(
            [pro[3 * i + 2] - pro[3 * i + 1] for i in blocks]),
        span_ns=max(ends) - min(starts),
        start_offset_ns_quartiles=quartiles(
            [s - min(starts) for s in starts]),
        block_life_ns_quartiles=quartiles(
            [e - s for s, e in zip(starts, ends)]))
    print(json.dumps(row))


if __name__ == "__main__":
    main()
