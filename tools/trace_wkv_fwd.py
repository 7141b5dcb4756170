"""Where a chunk's time goes in the WKV forward's Hopper kernel.

    python3 tools/trace_wkv_fwd.py [--src PATH/src] [--shape B,T,H,N]

Copies ``csrc/rwkv6_wkv.cu`` of the tree into ``build/trace_wkv_fwd/``,
adds marks to its wgmma kernel (``wkv_wg_kernel``) and builds that copy
with the tree's nvcc flags (``tools/trace_marks.py``); then calls it in
bf16 at rwkv6-3b's serve and train shape (4, 512, 40, 64), or ``--shape``
(B H <= 160, T <= 512, N = 64), and prints, from the global timer (ns)
that thread 0 of a block (the products' warpgroup) reads at each mark, the
phases of a chunk (median and quartiles over every block's chunks but the
first), a chunk's time, the pass warpgroups' time a chunk and their idle
time between chunks (thread 128), the prologue (the block's start to its
first chunk), the launch's span and the blocks' life.

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
PHASES = ("pass and v wait", "scores, readout, state products issued",
          "scores' wait", "mask, bonus, split, scores.v issued",
          "products' wait", "store read, barrier, r/k/w load issued",
          "S decay, S's hi and lo tiles", "out tile")
N_MARKS = len(PHASES) + 1
DEFS = f'''
__device__ unsigned long long g_marks[{MAX_BLOCKS * MAX_CHUNKS * N_MARKS}];
__device__ unsigned long long g_pass[{MAX_BLOCKS * MAX_CHUNKS * 2}];
__device__ unsigned long long g_pro[{MAX_BLOCKS * 2}];
#define BLOCK_ID (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x)
#define MARK(n) if (threadIdx.x == 0) {{ unsigned long long _gt; \\
  {GLOBALTIMER} g_marks[(BLOCK_ID * {MAX_CHUNKS} + c) * {N_MARKS} + (n)] \\
  = _gt; }}
#define PASSMARK(n) if (threadIdx.x == 128) {{ unsigned long long _gt; \\
  {GLOBALTIMER} g_pass[(BLOCK_ID * {MAX_CHUNKS} + c) * 2 + (n)] = _gt; }}
#define PMARK(n) if (threadIdx.x == 0) {{ unsigned long long _gt; \\
  {GLOBALTIMER} g_pro[BLOCK_ID * 2 + (n)] = _gt; }}
'''
# (anchor, mark, after): each anchor occurs once in csrc/rwkv6_wkv.cu
MARKS = (
    ("namespace {\n", DEFS, False),
    ("  const uint32_t bar_rkw = hp::smem_u32(full);\n", "  PMARK(0)\n",
     True),
    ("  for (int c = 0; c < K; ++c) {\n    // S_{c-1}'s tiles and chunk",
     "  PMARK(1)\n", False),
    ("    const int st = c & 1;\n    const uint32_t rd_hi = base + st * "
     "kRkwx;\n    const uint32_t vt", "    MARK(0)\n", False),
    ("    // 1. scores = r_dec . k_over^T; then", "    MARK(1)\n", False),
    ("    hp::wgmma_commit();\n    hp::wgmma_wait<1>();\n"
     "    hp::fence_regs(sc);\n", "    MARK(2)\n", False),
    ("    // 2. while the second group runs:", "    MARK(3)\n", False),
    ("    hp::wgmma_commit();\n    hp::wgmma_wait<0>();\n"
     "    hp::fence_regs(S);\n", "    MARK(4)\n", False),
    ("    // 3. every warp's products have read", "    MARK(5)\n", False),
    ("#pragma unroll\n    for (int j = 0; j < 8; ++j) {\n"
     "      S[4 * j] *= p0;\n", "    MARK(6)\n", False),
    ("    st_frag<false>(o_tile, 0, y);\n", "    MARK(7)\n", False),
    ("    st_frag<false>(o_tile, 0, y);\n    hp::fence_proxy_async();\n",
     f"    MARK({N_MARKS - 1})\n", True),
    ("      hp::mbar_wait(bar_rkw + 8 * st, (c >> 1) & 1);\n",
     "      PASSMARK(0)\n", True),
    ("      hp::mbar_arrive(bar_pass + 8 * st);\n", "      PASSMARK(1)\n",
     False),
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
    lib = build(src, "trace_wkv_fwd", "rwkv6_wkv.cu",
                lambda text: splice(text, MARKS, "tools/trace_wkv_fwd.py")
                + readers("g_marks", "g_pass", "g_pro"))
    launch = lib.rwkv6_wkv_launch
    launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    launch.restype = ctypes.c_int

    r, k, v, w, u, s0 = cs.wkv_inputs(shape, "bfloat16")
    out, state = torch.empty_like(r), torch.empty_like(s0)

    def marked():
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), s0.data_ptr(), out.data_ptr(),
                     state.data_ptr(), B, T, H, N, 64,
                     rwkv6_wkv.FWD_ROUTES.index("wgmma"),
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    print(cs.card_line())
    row = {"shape": list(shape), "device_ms_marked": cs.device_ms(marked),
           "device_ms_tree": cs.device_ms(
               lambda: rwkv6_wkv.rwkv6_wkv(r, k, v, w, u, s0))}
    marked()
    torch.cuda.synchronize()
    want_out, want_s = rwkv6_wkv.rwkv6_wkv(r, k, v, w, u, s0)
    row["marked_equals_tree"] = bool(torch.equal(out, want_out)
                                     and torch.equal(state, want_s))
    marks = read(lib, "g_marks", ctypes.c_ulonglong,
                 MAX_BLOCKS * MAX_CHUNKS * N_MARKS)
    pro = read(lib, "g_pro", ctypes.c_ulonglong, MAX_BLOCKS * 2)
    pas = read(lib, "g_pass", ctypes.c_ulonglong, MAX_BLOCKS * MAX_CHUNKS * 2)
    span = lambda i, c: (pas[(i * MAX_CHUNKS + c) * 2],  # noqa: E731
                         pas[(i * MAX_CHUNKS + c) * 2 + 1])
    at = lambda i, c: [marks[(i * MAX_CHUNKS + c) * N_MARKS + n]  # noqa
                       for n in range(N_MARKS)]
    chunks = [at(i, c) for i in range(B * H) for c in range(1, K)]
    starts = [pro[2 * i] for i in range(B * H)]
    ends = [at(i, K - 1)[-1] for i in range(B * H)]
    row.update(
        phases_ns_quartiles={
            name: quartiles([ch[n + 1] - ch[n] for ch in chunks])
            for n, name in enumerate(PHASES)},
        chunk_ns_quartiles=quartiles([ch[-1] - ch[0] for ch in chunks]),
        pass_ns_quartiles=quartiles(
            [span(i, c)[1] - span(i, c)[0] for i in range(B * H)
             for c in range(K)]),
        pass_idle_ns_quartiles=quartiles(
            [span(i, c)[0] - span(i, c - 1)[1] for i in range(B * H)
             for c in range(1, K)]),
        prologue_ns_quartiles=quartiles(
            [pro[2 * i + 1] - pro[2 * i] for i in range(B * H)]),
        span_ns=max(ends) - min(starts),
        start_offset_ns_quartiles=quartiles(
            [s - min(starts) for s in starts]),
        block_life_ns_quartiles=quartiles(
            [e - s for s, e in zip(starts, ends)]))
    print(json.dumps(row))


if __name__ == "__main__":
    main()
