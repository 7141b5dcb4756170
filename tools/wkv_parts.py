"""Time the WKV tensor-core kernel with one part of its work taken out.

    python3 tools/wkv_parts.py

Builds variants of ``src/repro_torch/kernels/csrc/rwkv6_wkv.cu`` under
``build/wkv_parts/``, each with one part of the bf16 route's work removed
by a text substitution (its result is wrong; only its time counts), and
times each at the serve shape (4, 512, 40, 64) with
``chip_smoke.device_ms``, in turns: every variant, then every variant
again in reverse order. A part whose removal saves little does not set the
kernel's time. Needs the card and nvcc, and fails if a substitution no
longer matches the source. Prints the card and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(1, HERE)

# part -> (text, replacement) pairs, each matching the source exactly once
PARTS = {
    "whole": [],
    "lo parts (one bf16 product each)": [
        ("mma_tiles<kD / 16>(yacc, rh[kk], bl);", ""),
        ("mma_tiles<kD / 16>(yacc, rl[kk], bh);", ""),
        ("mma_tiles<4>(sc, rh[kk], bl, n_tiles);", ""),
        ("mma_tiles<4>(sc, rl[kk], bh, n_tiles);", ""),
        ("mma_tiles<kD / 16>(yacc, pl, bv);", ""),
        ("mma_tiles<kD / 16>(sacc, al, bv);", "")],
    "mma (all products)": [
        ("    tc::mma_bf16(acc[2 * i], a, b[i][0], b[i][1]);\n"
         "    tc::mma_bf16(acc[2 * i + 1], a, b[i][2], b[i][3]);\n", "")],
    "log and exp": [
        ("lg2(fmaxf(wv.x, 1e-8f))", "fmaxf(wv.x, 1e-8f)"),
        ("lg2(fmaxf(wv.y, 1e-8f))", "fmaxf(wv.y, 1e-8f)"),
        ("rr[j] * ex2(cum - lw[kk][q][j])", "rr[j] * (cum - lw[kk][q][j])"),
        ("kq[j] * ex2(-cum)", "kq[j] * cum")],
    "shuffle scan": [
        ("const float yu = __shfl_up_sync(0xffffffffu, up, off);",
         "const float yu = up;"),
        ("const float yd = __shfl_up_sync(0xffffffffu, dn, off);",
         "const float yd = dn;"),
        ("dn += __shfl_sync(0xffffffffu, up, 28 + t);", "dn += up;")],
    "next chunk's loads": [
        ("      load_rkw(t0 + c);\n      load_v(t0 + c, st ^ 1);\n", "")],
    "output stores": [
        ("            st_bf16x2(dst + m, tc::pack_bf16(y0, y1));\n", "")],
    "barriers (2) and (3)": [
        ("    __syncthreads();   // (2) every warp's column totals\n", ""),
        ("    __syncthreads();   // (3) k_over is in; r, k, w are read\n", "")],
}
SHAPE = (4, 512, 40, 64)


def variant(name: str, edits) -> str:
    from repro_torch.kernels import _build
    src = (_build.CSRC / "rwkv6_wkv.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} matches "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    out = os.path.join(HERE, "build", "wkv_parts",
                       str(list(PARTS).index(name)))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "rwkv6_wkv.cu"), "w") as f:
        f.write(src)
    lib = os.path.join(out, "librwkv6_wkv.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", lib, os.path.join(out, "rwkv6_wkv.cu")],
                   check=True, capture_output=True)
    return lib


def main() -> None:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.kernels.mamba2_ssd import pick_chunk
    B, T, H, N = SHAPE
    r, k, v, w, u, s0 = cs.wkv_inputs(SHAPE, "bfloat16")
    out = torch.empty_like(r)
    state = torch.empty_like(s0)
    calls = {}
    for name, edits in PARTS.items():
        fn = ctypes.CDLL(variant(name, edits)).rwkv6_wkv_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ptrs = [a.data_ptr() for a in (r, k, v, w, u, s0, out, state)]

        def call(fn=fn, ptrs=ptrs):
            err = fn(*ptrs, B, T, H, N, pick_chunk(T), 1,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        calls[name] = call
    times = {name: [] for name in PARTS}
    for name in list(PARTS) + list(PARTS)[::-1]:
        times[name].append(cs.device_ms(calls[name]))
    print(cs.card_line())
    print(json.dumps({"shape": list(SHAPE), "device_ms": times}))


if __name__ == "__main__":
    main()
