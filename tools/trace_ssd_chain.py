"""Where a head's time goes in the SSD backward's cluster kernel.

    python3 tools/trace_ssd_chain.py [--src PATH/src]

Copies ``csrc/mamba2_ssd_bwd.cu`` of the tree into
``build/trace_ssd_chain/``, adds marks to ``ssd_bwd_cluster_kernel`` and
builds that copy with the tree's nvcc flags (``tools/trace_marks.py``);
then calls it at zamba2's train shape (4, 512, 112, 64, 1, 64) in bf16, as
the train step does (no final-state gradient, ``cluster_heads(H)`` heads a
block), and prints:

- the chain: for one cluster (head group 1, batch 1) and each of its heads,
  the time (global timer, ns) at which each block has passed S and dS' on,
  and the median gap between neighbouring blocks (a hop), for S (block k -
  1 to k) and for dS' (block k + 1 to k);
- the phases of one block (chunk 3 of that cluster), clock64 cycles a head
  (median over the heads but the first): the vectors, the wait for x and
  dy, U and V, the chain with the S and dS' tiles and the sum of S o dS',
  rows t, rows s, and the rest (the next head's loads and warp 0's ddt).

The marks are stores by one thread of a block: the kernel's time shifts by
a few percent (it prints ``device_ms`` of the marked copy beside the
tree's own). Needs the card; the tree's own kernels are not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import sys

from trace_marks import GLOBALTIMER, HERE, build, read, readers, splice

SHAPE = (4, 512, 112, 64, 1, 64)
PHASES = ("vectors", "x, dy wait", "U, V", "chain, tiles, sum", "rows t",
          "rows s", "rest")
DEFS = '''
__device__ unsigned long long g_phase[64 * 16];
__device__ unsigned long long g_chain[8 * 64 * 4];
#define TRACED (blockIdx.y == 1 && blockIdx.z == 1 && i < 64)
#define PHASE(n) if (threadIdx.x == 0 && blockIdx.x == 3 && TRACED) \\
  g_phase[i * 16 + (n)] = clock64();
#define CHAIN(n) if (threadIdx.x == 0 && TRACED) { unsigned long long _gt; \\
  ''' + GLOBALTIMER + ''' g_chain[(blockIdx.x * 64 + i) * 4 + (n)] = _gt; }
'''
# (anchor, mark, after): each anchor occurs once in csrc/mamba2_ssd_bwd.cu
MARKS = (
    ("namespace {\n\nconstexpr int kThreads = 512;", DEFS, False),
    ("  for (int i = 0; i < heads; ++i) {\n", "    PHASE(0)\n", True),
    ("    __syncthreads();   // (1) the head's vectors\n", "    PHASE(1)\n",
     True),
    ("    wait_phase(xy_full, i & 1);\n", "    PHASE(2)\n", True),
    ("    // The chain: S from block k - 1 (or state0), dS' from block k + 1"
     " (or\n", "    PHASE(3)\n", False),
    ("    __syncthreads();   // (2) S and dS' in their tiles; the chain copies"
     " read\n", "    PHASE(4)\n", True),
    ("    __syncthreads();   // (3) the M and dG tiles are in\n",
     "    PHASE(5)\n", True),
    ("    __syncthreads();   // (4) x, dy, M and dG are read; the vectors are"
     " in\n", "    PHASE(6)\n", True),
    ("  }\n\n  // the group's dB and dC, rows of the chunk, as one partial sum"
     "\n", "    PHASE(7)\n", False),
    ("    if (first || last) tc::cp_async_wait<0>();   // the prefetched"
     " states\n", "    CHAIN(0)\n", False),
    ("      to_tiles(S, kTSh, kTSl);\n", "      CHAIN(1)\n", False),
    ("      to_tiles(dS, kTDh, kTDl);\n", "      CHAIN(2)\n", False),
    ("    // the sum of S o dS', from the f32 copies the chain left\n",
     "    CHAIN(3)\n", False),
)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(HERE, "src"))
    args = parser.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import mamba2_ssd
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    lib = build(src, "trace_ssd_chain", "mamba2_ssd_bwd.cu",
                lambda text: splice(text, MARKS, "tools/trace_ssd_chain.py")
                + readers("g_phase", "g_chain"))
    launch = lib.mamba2_ssd_bwd_launch
    launch.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    launch.restype = ctypes.c_int

    (x, dt, A, Bm, Cm, s0), dout, _ = cs.scan_bwd_inputs(
        "mamba2_ssd", SHAPE, "bfloat16")
    B, T, H, P, G, N = SHAPE
    K, heads = T // 64, mamba2_ssd.cluster_heads(H)
    f32 = dict(dtype=torch.float32, device=x.device)

    def marked():
        grads = [torch.empty_like(a) for a in (x, dt, A, Bm, Cm, s0)]
        work = [torch.empty(B, T, H // heads, N, **f32),
                torch.empty(B, T, H // heads, N, **f32),
                torch.empty(B * H * K, **f32)]
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), s0.data_ptr(),
                     dout.data_ptr(), 0, grads[0].data_ptr(),
                     grads[1].data_ptr(), grads[2].data_ptr(),
                     grads[3].data_ptr(), grads[4].data_ptr(),
                     grads[5].data_ptr(), 0, 0,
                     *(w.data_ptr() for w in work), B, T, H, P, G, N, 64, 2,
                     heads, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    print(cs.card_line())
    print(f"device_ms: marked copy {cs.device_ms(marked)}, the tree's "
          f"{cs.device_ms(lambda: mamba2_ssd.mamba2_ssd_bwd(*(x, dt, A, Bm, Cm, s0), dout))}")
    marked()
    torch.cuda.synchronize()
    phase = read(lib, "g_phase", ctypes.c_ulonglong, 64 * 16)
    chain = read(lib, "g_chain", ctypes.c_ulonglong, 8 * 64 * 4)
    at = lambda k, i, n: chain[(k * 64 + i) * 4 + n]  # noqa: E731
    t0 = min(at(k, 0, 0) for k in range(K))
    s_hops, d_hops = [], []
    for i in range(heads):
        s_done = [at(k, i, 1) for k in range(K)]
        d_done = [at(k, i, 2) for k in range(K)]
        s_hops += [s_done[k] - s_done[k - 1] for k in range(1, K)]
        d_hops += [d_done[k] - d_done[k + 1] for k in range(K - 1)]
        if i < 3:
            print(f"head {i}: S passed on at (ns from the first block's "
                  f"start) {[v - t0 for v in s_done]}, dS' "
                  f"{[v - t0 for v in d_done]}, chain ends "
                  f"{[at(k, i, 3) - t0 for k in range(K)]}")
    print(f"hop ns (median, quartiles): S {statistics.median(s_hops)} "
          f"{statistics.quantiles(s_hops, n=4)}, dS' "
          f"{statistics.median(d_hops)} "
          f"{statistics.quantiles(d_hops, n=4)}")
    cycles = [[phase[i * 16 + n + 1] - phase[i * 16 + n] for n in range(7)]
              for i in range(1, heads)]
    print("cycles a head (median over heads 1..): " + ", ".join(
        f"{name} {statistics.median(c[n] for c in cycles)}"
        for n, name in enumerate(PHASES)))


if __name__ == "__main__":
    main()
