"""Where a chunk's time goes in the SSD forward's Hopper kernel.

    python3 tools/trace_ssd_fwd.py [--src PATH/src] [--shape B,T,H,P,G,N]

Copies ``csrc/mamba2_ssd.cu`` of the tree into ``build/trace_ssd_fwd/``,
adds marks to its warpgroup kernel (``ssd_wg_kernel``) and builds that copy
with the tree's nvcc flags (``tools/trace_marks.py``); then calls it in
bf16 at zamba2-7b's serve and train shape (4, 512, 112, 64, 1, 64), or
``--shape`` (B H <= 448, T <= 512), and prints, from the global timer (ns)
that thread 0 of a block reads at each mark, the phases of a chunk
(median and quartiles over every block's chunks but the first), a chunk's
time, the launch's span and the blocks' life.

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

SHAPE = (4, 512, 112, 64, 1, 64)
MAX_BLOCKS, MAX_CHUNKS = 4 * 112, 8
PHASES = ("tiles wait", "G, next loads, P",
          "(B o w) fragments, S tile, L start, C o exp(cum)", "L wait",
          "y start", "vectors, y wait", "y tile, store")
N_MARKS = len(PHASES) + 1
DEFS = f'''
__device__ unsigned long long g_marks[{MAX_BLOCKS * MAX_CHUNKS * N_MARKS}];
#define MARK(n) if (threadIdx.x == 0) {{ unsigned long long _gt; \\
  {GLOBALTIMER} g_marks[((static_cast<size_t>(blockIdx.y) * gridDim.x + \\
  blockIdx.x) * {MAX_CHUNKS} + c) * {N_MARKS} + (n)] = _gt; }}
'''
# (anchor, mark, after): each anchor occurs once in csrc/mamba2_ssd.cu
MARKS = (
    ("namespace {\n", DEFS, False),
    ("    const float* v = vecs + (c & 1) * kWgVec;\n", "    MARK(0)\n", True),
    ("    // 1. G = C . B^T; masked", "    MARK(1)\n", False),
    ("    // 2. (B o w)^T as A fragments", "    MARK(2)\n", False),
    ("    hp::fence_proxy_async();\n    __syncthreads();\n"
     "    hp::wgmma_wait<0>();\n", "    MARK(3)\n", False),
    ("    // 3. y = P . x + (C o exp(cum)) . S_c;", "    MARK(4)\n", False),
    ("    if (warp == 0 && c + 1 < K) {\n      tc::cp_async_wait<0>();\n",
     "    MARK(5)\n", False),
    ("    hp::fence_regs(yv);\n", "    MARK(6)\n", True),
    ("      hp::tma_store_commit();\n    }\n", f"    MARK({N_MARKS - 1})\n",
     True),
)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(HERE, "src"))
    parser.add_argument("--shape", default=",".join(map(str, SHAPE)),
                        help="B,T,H,P,G,N (B H <= 448, T <= 512)")
    args = parser.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import mamba2_ssd
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    shape = tuple(int(v) for v in args.shape.split(","))
    B, T, H, P, G, N = shape
    K = T // 64
    if B * H > MAX_BLOCKS or K > MAX_CHUNKS:
        raise SystemExit(f"--shape: B H <= {MAX_BLOCKS}, T <= "
                         f"{64 * MAX_CHUNKS}")
    lib = build(src, "trace_ssd_fwd", "mamba2_ssd.cu",
                lambda text: splice(text, MARKS, "tools/trace_ssd_fwd.py")
                + readers("g_marks"))
    launch = lib.mamba2_ssd_launch
    launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    launch.restype = ctypes.c_int

    x, dt, A, Bm, Cm, s0 = cs.ssd_inputs(shape, "bfloat16")
    y, state = torch.empty_like(x), torch.empty_like(s0)

    def marked():
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), s0.data_ptr(),
                     y.data_ptr(), state.data_ptr(), B, T, H, P, G, N, 64,
                     mamba2_ssd.FWD_ROUTES.index("warpgroup"),
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    print(cs.card_line())
    row = {"device_ms_marked": cs.device_ms(marked),
           "device_ms_tree": cs.device_ms(
               lambda: mamba2_ssd.mamba2_ssd(x, dt, A, Bm, Cm, s0))}
    marked()
    torch.cuda.synchronize()
    want_y, want_s = mamba2_ssd.mamba2_ssd(x, dt, A, Bm, Cm, s0)
    row["marked_equals_tree"] = bool(torch.equal(y, want_y)
                                     and torch.equal(state, want_s))
    marks = read(lib, "g_marks", ctypes.c_ulonglong,
                 MAX_BLOCKS * MAX_CHUNKS * N_MARKS)
    at = lambda i, c: [marks[(i * MAX_CHUNKS + c) * N_MARKS + n]  # noqa
                       for n in range(N_MARKS)]
    chunks = [at(i, c) for i in range(B * H) for c in range(1, K)]
    starts = [at(i, 0)[0] for i in range(B * H)]
    ends = [at(i, K - 1)[-1] for i in range(B * H)]
    row.update(
        phases_ns_quartiles={
            name: quartiles([ch[n + 1] - ch[n] for ch in chunks])
            for n, name in enumerate(PHASES)},
        chunk_ns_quartiles=quartiles([ch[-1] - ch[0] for ch in chunks]),
        span_ns=max(ends) - min(starts),
        block_life_ns_quartiles=quartiles(
            [e - s for s, e in zip(starts, ends)]))
    print(json.dumps(row))


if __name__ == "__main__":
    main()
