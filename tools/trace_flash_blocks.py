"""Where a block of the bf16 flash forward (the wgmma kernel) spends its time.

    python3 tools/trace_flash_blocks.py [--src PATH/src]

Copies the tree's ``repro_torch`` into ``build/trace_flash/``, adds clock
marks to ``flash_fwd_wg_kernel`` (consumer warpgroup 0, and both
warpgroups' ends; each block also records its SM and its start on the
global timer; ``tools/trace_marks.py`` splices them), builds that copy
with the package's own loader, launches it at the main-path shapes in
both modes and prints, for each, the median and 10th / 90th percentile
of each phase's end (microseconds from the block's start: clock64 cycles
over the clock rate each block measured against the global timer), the
blocks an SM and the gap between one block's end and the next block's
start on the same SM.
The marks are stores of a few threads: the kernel's times shift by a few
percent (it prints ``device_ms`` of the marked copy). Needs the card; the
tree's own kernels are not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

from trace_marks import HERE, readers, splice

SHAPES = ((4, 512, 48, 128), (4, 512, 32, 112), (4, 512, 12, 128))
PHASES = (("Q and first K landed", 2), ("first tile done", 3),
          ("kv loop done", 4), ("last P V done", 5),
          ("warpgroup 0 stored", 6), ("warpgroup 1 stored", 7))

# (anchor, mark, after) in csrc/flash_attention.cu; each anchor must occur
# once
MARKS = (
    ("constexpr int kWgBlockQ = 128;",
     "__device__ unsigned long long g_trace[1 << 14][10];\n", False),
    ("  if (threadIdx.x == 256) {\n    hp::prefetch_tensormap(&tm_q);",
     "  const long long c0 = clock64();\n"
     "  if (threadIdx.x == 0 && blockIdx.x < (1 << 14)) {\n"
     "    unsigned sm;\n"
     "    unsigned long long ns;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ns));\n"
     "    g_trace[blockIdx.x][0] = sm;\n"
     "    g_trace[blockIdx.x][1] = ns;\n"
     "  }\n"
     "  auto mark = [&](int slot) {\n"
     "    if ((threadIdx.x & 127) == 0 && blockIdx.x < (1 << 14))\n"
     "      g_trace[blockIdx.x][slot] = clock64() - c0;\n"
     "  };\n"
     "  auto stamp = [&]() {\n"
     "    unsigned long long ns;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ns));\n"
     "    g_trace[blockIdx.x][8] = clock64() - c0;\n"
     "    g_trace[blockIdx.x][9] = ns;\n"
     "  };\n", False),
    ("    turn();\n    hp::wgmma_fence();\n    issue_qk(0);",
     "    if (wg == 0) mark(2);\n", False),
    ("\n    for (int j = 1; j < n_mine; ++j) {",
     "\n    if (wg == 0) mark(3);", False),
    ("    const int last = n_mine - 1;", "    if (wg == 0) mark(4);\n",
     False),
    ("    // epilogue: O / l in bf16", "    if (wg == 0) mark(5);\n", False),
    ("      hp::tma_store_wait_read();\n    }\n",
     "    mark(6 + wg);\n"
     "    if (threadIdx.x == 128 && blockIdx.x < (1 << 14)) stamp();\n",
     True),
)


def instrument(src: str, dst: str) -> None:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(src, "repro_torch"),
                    os.path.join(dst, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "repro_torch", "kernels", "csrc",
                        "flash_attention.cu")
    text = open(path).read()
    text = splice(text, MARKS, "tools/trace_flash_blocks.py")
    open(path, "w").write(text + readers("g_trace"))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(HERE, "src"),
                        help="the tree's src directory (holds repro_torch)")
    args = parser.parse_args()
    dst = os.path.join(HERE, "build", "trace_flash", "src")
    instrument(os.path.abspath(args.src), dst)
    sys.path.insert(0, dst)
    sys.path.insert(1, HERE)
    import numpy as np
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._build import load
    lib = load("flash_attention")
    lib.trace_read_g_trace.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.trace_read_g_trace.restype = ctypes.c_int
    print(cs.card_line())
    for shape in SHAPES:
        B, S, H, _ = shape
        blocks = B * H * ((S + 127) // 128)
        q, k, v = cs.attention_inputs(shape, "bfloat16")
        for causal in (True, False):
            run = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa
            ms = cs.device_ms(run)
            run()
            torch.cuda.synchronize()
            buf = np.zeros((1 << 14, 10), dtype=np.uint64)
            if lib.trace_read_g_trace(buf.ctypes.data, buf.nbytes) != 0:
                raise SystemExit("reading the marks failed")
            t = buf[:blocks].astype(np.int64)
            # cycles a microsecond, from the global timer (ns) over a block
            mhz = np.median(t[:, 8] / (t[:, 9] - t[:, 1]) * 1e3)
            us = t[:, 2:8] / mhz
            start = (t[:, 1] - t[:, 1].min()) / 1e3
            end = start + us[:, 4:].max(axis=1)
            by_sm = {}
            for i in range(blocks):
                by_sm.setdefault(int(t[i, 0]), []).append(i)
            gaps = []
            for ids in by_sm.values():
                ids.sort(key=lambda i: start[i])
                gaps += [start[b] - end[a] for a, b in zip(ids, ids[1:])]
            print(f"{shape} causal={causal}: {blocks} blocks on "
                  f"{len(by_sm)} SMs ({min(map(len, by_sm.values()))}-"
                  f"{max(map(len, by_sm.values()))} each), device_ms {ms}, "
                  f"SM clock {mhz:.0f} MHz")
            for name, slot in PHASES:
                x = us[:, slot - 2]
                print(f"  {name:22s} median {np.median(x):.2f} us "
                      f"(p10 {np.percentile(x, 10):.2f}, p90 "
                      f"{np.percentile(x, 90):.2f})")
            if gaps:
                print(f"  gap before the SM's next block: median "
                      f"{np.median(gaps):.2f} us (p90 "
                      f"{np.percentile(gaps, 90):.2f})")


if __name__ == "__main__":
    main()
