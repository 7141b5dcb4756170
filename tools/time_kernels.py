"""Time the port's CUDA kernels of one source tree on the card.

    python3 tools/time_kernels.py --src PATH/src

Builds the kernels of the tree under ``PATH`` (its own ``build/``), then
times each at its main path's shape with ``chip_smoke.py``'s methods
(median device time behind a spin kernel, and CUPTI busy time): an empty
kernel (the floor), ``anen_distance`` at (365, 3, 512) and (365, 3, 4096),
``rwkv6_wkv`` at (4, 512, 40, 64) in bf16 and f32, ``flash_attention`` and
``mamba2_ssd`` at theirs in bf16 (``flash_attention`` also at
stablelm-12b's and minitron-4b's shapes), and ``flash_attention_bwd`` in
bf16 at (4, 512, 12, 128) and (4, 512, 32, 112) (device time and CUPTI
busy time); then the registers and spills of the bf16 flash kernels
(forward, dk/dv, dq) at head dims 112, 128 and 160 as the tree compiles
them (its default, causal, kernels). Where the tree's ``flash_attention``
takes ``causal``, the same for ``causal=False``: the forward at the three
shapes, the backward at both, the registers and spills. The inputs are
``chip_smoke.py``'s.

    python3 tools/time_kernels.py --src PATH/src --only flash_fwd

times the bf16 flash forward alone, in both modes, at the seven shapes of
``chip_smoke.FLASH_TIMED`` and ``FLASH_MAIN`` (device time, the host's
``call_ms``, and ``scaled_dot_product_attention`` on the same inputs as
the yardstick), with the tree's route at each shape where it reports one,
and the registers and spills at head dims 64, 112, 128 and 160.

    python3 tools/time_kernels.py --src PATH/src --only flash_bwd

times the bf16 flash backward alone, in both modes, at
``chip_smoke.FLASH_BWD_TIMED``, ``FLASH_MANAGED_TRAIN``, (4, 512, 24, 128)
and (4, 512, 48, 128): device time by CUDA events, CUPTI busy time by
kernel (delta, dk/dv, dq), the backward of
``scaled_dot_product_attention`` on the same inputs as the yardstick
(``chip_smoke.time_flash_bwd``'s), the bound and the tree's route; then
the route, registers, spills and threads of the dk/dv and dq kernels at
head dims 32, 64, 112, 128 and 160.

    python3 tools/time_kernels.py --src PATH/src --only ssd_bwd

times the bf16 SSD backward alone, as the train step calls it (no
final-state gradient), at zamba2-7b's train shape (4, 512, 112, 64, 1, 64)
and at (4, 100, 112, 64, 1, 64) and (2, 128, 8, 64, 2, 64): device time by
CUDA events, CUPTI busy time by kernel (the cluster kernel, or the walk
and the chunk kernel, then the sums), the bound and the tree's route
(``mamba2_ssd.bwd_route`` where the tree has it, else "mma.sync"); then
the registers, spills, blocks an SM and threads of the tree's compiled
backward kernels at N = P = chunk = 64.

    python3 tools/time_kernels.py --src PATH/src --only ssd_fwd

times the bf16 SSD forward alone at zamba2-7b's serve and train shape
(4, 512, 112, 64, 1, 64), and at (4, 100, 112, 64, 1, 64) and (2, 128, 8,
64, 2, 64): device time by CUDA events (median of 60), CUPTI busy time,
the bound and the tree's route (``mamba2_ssd.fwd_route`` where the tree
has it, else "mma.sync"); then the registers, spills, blocks an SM and
threads of the tree's compiled bf16 forward kernels at N = P = chunk = 64
(the mma.sync kernel, and the warpgroup kernel where the tree has it).

    python3 tools/time_kernels.py --src PATH/src --only wkv_fwd

times the bf16 WKV forward alone at rwkv6-3b's serve and train shape
(4, 512, 40, 64), at one batch row of its heads (1, 512, 40, 64), at
(2, 128, 3, 64) and at (4, 100, 40, 64) (chunk 50): device time by CUDA
events (median of 60), CUPTI busy time, the bound and the tree's route
(``rwkv6_wkv.fwd_route`` where the tree has it, else "mma"); then the
registers, spills, blocks an SM and threads of the tree's compiled bf16
forward kernels at N = chunk = 64 (the mma.sync kernel, and the wgmma
kernel where the tree has it).

    python3 tools/time_kernels.py --src PATH/src --only wkv_bwd

times the bf16 WKV backward alone, as the train step calls it (no
final-state gradient), at rwkv6-3b's train shape (4, 512, 40, 64), at one
batch row of its heads (1, 512, 40, 64), at (2, 128, 3, 64) with w drawn
to reach both clamps and at (4, 100, 40, 64) (chunk 50): device time by
CUDA events, CUPTI busy time by kernel, the bound and the tree's route
(``rwkv6_wkv.bwd_route`` where the tree has it, else "mma"); then the
registers, spills, blocks an SM and threads of the tree's compiled bf16
backward kernels at N = chunk = 64 (the mma.sync route's chunk kernel and
walk, and the wgmma kernel where the tree has it).

    python3 tools/time_kernels.py --src PATH/src --only rms_norm

times the fused residual add and RMSNorm against the plain chain it
replaces (the add, then eight float32 launches), in turns (fused, plain,
plain, fused), at (8192, 4096), (1024, 4096) and (4, 4096) in bf16, with
and without the add: device time by CUDA events (median of 60, an event
between calls) and CUPTI busy time (the kernels alone), each call on the
next of enough distinct inputs to fill four times the 50 MB L2, so that
every read comes from device memory; each against its HBM bound;
then the compiled kernel's registers, spills, blocks an SM and threads at
each shape. The tree must have the kernel (``kernels/rms_norm.py``).
Each mode prints the card and one JSON line. Two trees compare on one
card when they run in turns in one session: parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", required=True,
                        help="the tree's src directory (holds repro_torch)")
    parser.add_argument("--only", choices=("all", "flash_fwd", "flash_bwd",
                                           "ssd_fwd", "ssd_bwd", "wkv_fwd",
                                           "wkv_bwd", "rms_norm"),
                        default="all", help="time every kernel, or the bf16 "
                        "flash forward or backward, the SSD forward or "
                        "backward, the WKV forward or backward or the fused "
                        "norm alone")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.kernels import (anen_distance, flash_attention,
                                     mamba2_ssd, rwkv6_wkv)
    if args.only == "flash_fwd":
        from repro_torch.kernels._build import load
        load("flash_attention")
    elif args.only == "flash_bwd":
        build_both(args.src, ("flash_attention", "flash_attention_bwd"))
    elif args.only == "ssd_bwd":
        build_both(args.src, ("mamba2_ssd", "mamba2_ssd_bwd"))
    elif args.only == "ssd_fwd":
        from repro_torch.kernels._build import load
        load("mamba2_ssd")
    elif args.only == "wkv_fwd":
        from repro_torch.kernels._build import load
        load("rwkv6_wkv")
    elif args.only == "wkv_bwd":
        from repro_torch.kernels._build import load
        load("rwkv6_wkv_bwd")
    elif args.only == "rms_norm":
        from repro_torch.kernels._build import load
        load("rms_norm")
    else:
        for kmod in (anen_distance, flash_attention, mamba2_ssd, rwkv6_wkv):
            kmod.build()

    rows = {"src": os.path.abspath(args.src), "card": cs.card_line(),
            "empty_kernel_ms": cs.empty_ms()}
    if args.only != "all":
        part = {"flash_fwd": flash_forward, "flash_bwd": flash_backward,
                "ssd_fwd": ssd_forward, "ssd_bwd": ssd_backward,
                "wkv_fwd": wkv_forward, "wkv_bwd": wkv_backward,
                "rms_norm": norm_timing}[args.only]
        mod = {"ssd": mamba2_ssd, "wkv": rwkv6_wkv}.get(args.only[:3],
                                                        flash_attention)
        if args.only == "rms_norm":
            from repro_torch.kernels import rms_norm as mod
        rows.update(part(cs, mod))
        print(rows["card"])
        print(json.dumps(rows))
        return
    for shape in ((365, 3, 512), (365, 3, 4096)):
        fh, fn = cs.distance_inputs(shape)
        rows[f"anen_distance {shape}"] = cs.device_ms(
            lambda: anen_distance.anen_distance(fh, fn))
    for dtype in ("bfloat16", "float32"):
        a = cs.wkv_inputs(cs.WKV_MAIN, dtype)
        fn = lambda: rwkv6_wkv.rwkv6_wkv(*a)             # noqa: E731
        rows[f"rwkv6_wkv {dtype}"] = cs.device_ms(fn)
        rows[f"rwkv6_wkv {dtype} busy"] = cs.busy_ms(fn)
    q, k, v = cs.attention_inputs(cs.FLASH_MAIN, "bfloat16")
    rows["flash_attention bfloat16"] = cs.device_ms(
        lambda: flash_attention.flash_attention(q, k, v))
    for shape in (cs.FLASH_STABLELM, cs.FLASH_MINITRON):
        q, k, v = cs.attention_inputs(shape, "bfloat16")
        rows[f"flash_attention bfloat16 {shape}"] = cs.device_ms(
            lambda: flash_attention.flash_attention(q, k, v))
    for shape in cs.FLASH_BWD_TIMED:
        q, k, v = cs.attention_inputs(shape, "bfloat16")
        dout = cs.attention_inputs(shape, "bfloat16", seed=12)[0]
        out, lse = flash_attention.flash_attention(q, k, v)
        fn = lambda: flash_attention.flash_attention_bwd(  # noqa: E731
            q, k, v, out, lse, dout)
        rows[f"flash_attention_bwd bfloat16 {shape}"] = cs.device_ms(fn)
        rows[f"flash_attention_bwd bfloat16 {shape} busy"] = cs.busy_ms(fn)
    s = cs.ssd_inputs(cs.SSD_MAIN, "bfloat16")
    rows["mamba2_ssd bfloat16"] = cs.device_ms(
        lambda: mamba2_ssd.mamba2_ssd(*s))
    modes = {"": {}}
    if "causal" in inspect.signature(
            flash_attention.flash_attention).parameters:
        modes[" causal=False"] = {"causal": False}
    for mode, kw in modes.items():
        if kw:
            for shape in (cs.FLASH_MAIN, cs.FLASH_STABLELM,
                          cs.FLASH_MINITRON):
                q, k, v = cs.attention_inputs(shape, "bfloat16")
                rows[f"flash_attention bfloat16{mode} {shape}"] = \
                    cs.device_ms(lambda: flash_attention.flash_attention(
                        q, k, v, **kw))
            for shape in cs.FLASH_BWD_TIMED:
                q, k, v = cs.attention_inputs(shape, "bfloat16")
                dout = cs.attention_inputs(shape, "bfloat16", seed=12)[0]
                out, lse = flash_attention.flash_attention(q, k, v, **kw)
                rows[f"flash_attention_bwd bfloat16{mode} {shape}"] = \
                    cs.device_ms(lambda: flash_attention.flash_attention_bwd(
                        q, k, v, out, lse, dout, **kw))
        for hd in (112, 128, 160):
            info = flash_attention.kernel_info(hd, torch.bfloat16, **kw)
            rows[f"flash_attention{mode} registers/spill hd {hd}"] = [
                info["registers"], info["spill_bytes"]]
            for which in ("dkdv", "dq"):
                info = flash_attention.bwd_kernel_info(hd, torch.bfloat16,
                                                       which, **kw)
                rows[f"flash_attention_bwd {which}{mode} registers/spill "
                     f"hd {hd}"] = [info["registers"], info["spill_bytes"]]
    print(rows["card"])
    print(json.dumps(rows))


def flash_forward(cs, flash_attention) -> dict:
    """The bf16 forward at ``FLASH_MAIN`` and ``FLASH_TIMED`` in both
    modes: device ms, call ms, SDPA's device ms and the route; then the
    registers and spills of the compiled forward at head dims 64, 112,
    128 and 160 (and the threads a block)."""
    import torch
    import torch.nn.functional as F
    rows = {}
    route = getattr(flash_attention, "route", None)
    for shape in (cs.FLASH_MAIN, *cs.FLASH_TIMED):
        q, k, v = cs.attention_inputs(shape, "bfloat16")
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        for causal in (True, False):
            fn = lambda: flash_attention.flash_attention(  # noqa: E731
                q, k, v, causal=causal)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal)
            rows[f"flash_attention bfloat16 causal={causal} {shape}"] = {
                "ms": cs.device_ms(fn), "call_ms": cs.call_ms(fn),
                "library_ms": cs.device_ms(lib),
                "route": route(q, k, v) if route else "mma.sync"}
    for causal in (True, False):
        for hd in (64, 112, 128, 160):
            info = flash_attention.kernel_info(hd, torch.bfloat16, causal)
            rows[f"flash_attention causal={causal} registers/spill/threads "
                 f"hd {hd}"] = [info["registers"], info["spill_bytes"],
                                info["threads"]]
    return rows


def build_both(src: str, names: tuple) -> None:
    """A forward's and its backward's libraries of the tree, one nvcc
    each, started together."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    procs = [subprocess.Popen([sys.executable, "-m",
                               "repro_torch.kernels._build", name], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for name in names]
    for proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"build failed:\n{err}")


def flash_backward(cs, flash_attention) -> dict:
    """The bf16 backward at the timed shapes in both modes: device ms,
    busy ms by kernel, SDPA's backward (device ms), the bound and the
    route; then the dk/dv and dq kernels' route, registers, spills and
    threads at head dims 32, 64, 112, 128 and 160."""
    import torch
    import torch.nn.functional as F
    rows = {}
    route = getattr(flash_attention, "bwd_route", None)
    shapes = (*cs.FLASH_BWD_TIMED, cs.FLASH_MANAGED_TRAIN, cs.FLASH_MINITRON,
              cs.FLASH_DBRX)
    for shape in shapes:
        q, k, v = cs.attention_inputs(shape, "bfloat16")
        dout = cs.attention_inputs(shape, "bfloat16", seed=12)[0]
        qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True)
                      for a in (q, k, v))
        dout_t = dout.transpose(1, 2).contiguous()
        for causal in (True, False):
            out, lse = flash_attention.flash_attention(q, k, v,
                                                       causal=causal)
            fn = lambda: flash_attention.flash_attention_bwd(  # noqa: E731
                q, k, v, out, lse, dout, causal=causal)
            sdpa = F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
            lib = lambda: torch.autograd.grad(  # noqa: E731
                sdpa, (qt, kt, vt), dout_t, retain_graph=True)
            row = {"ms": cs.device_ms(fn),
                   "parts_busy_ms": cs.bwd_parts_ms(fn),
                   "library_ms": cs.device_ms(lib),
                   "route": (route(q, k, v, out, dout) if route
                             else "mma.sync")}
            row.update(cs.flash_bwd_bound(shape, 2, causal))
            rows[f"flash_attention_bwd bfloat16 causal={causal} {shape}"] = \
                row
            del sdpa
    for causal in (True, False):
        for hd in (32, 64, 112, 128, 160):
            for which in ("dkdv", "dq"):
                info = flash_attention.bwd_kernel_info(hd, torch.bfloat16,
                                                       which, causal)
                rows[f"flash_attention_bwd {which} causal={causal} "
                     f"route/registers/spill/threads hd {hd}"] = [
                    info.get("route", "mma.sync"), info["registers"],
                    info["spill_bytes"], info["threads"]]
    return rows


SSD_TIMED = ((4, 512, 112, 64, 1, 64), (4, 100, 112, 64, 1, 64),
                 (2, 128, 8, 64, 2, 64))



def ssd_forward(cs, mamba2_ssd) -> dict:
    """The bf16 SSD forward at ``SSD_TIMED``: device ms, CUPTI busy
    ms, the bound and the route; then the compiled forward kernels at N =
    P = chunk = 64."""
    import torch
    rows = {}
    route = getattr(mamba2_ssd, "fwd_route", None)
    for shape in SSD_TIMED:
        args = cs.ssd_inputs(shape, "bfloat16")
        fn = lambda: mamba2_ssd.mamba2_ssd(*args)  # noqa: E731
        row = {"ms": cs.device_ms(fn),
               "busy_ms": cs.busy_ms(fn, f"mamba2_ssd {shape}"),
               "route": (route(args[0], args[3], args[4]) if route
                         else "mma.sync")}
        row.update(cs.ssd_bound(shape, 2))
        rows[f"mamba2_ssd bfloat16 {shape}"] = row
    info = mamba2_ssd.kernel_info(64, 64, 64, torch.bfloat16)
    rows["mamba2_ssd mma.sync registers/spill/blocks/threads"] = [
        info["registers"], info["spill_bytes"], info["blocks_per_sm"],
        info["threads"]]
    if route:
        info = mamba2_ssd.kernel_info(64, 64, 64, torch.bfloat16,
                                      "warpgroup")
        rows["mamba2_ssd warpgroup registers/spill/blocks/threads"] = [
            info["registers"], info["spill_bytes"], info["blocks_per_sm"],
            info["threads"]]
    return rows


WKV_TIMED = ((4, 512, 40, 64), (1, 512, 40, 64), (2, 128, 3, 64),
             (4, 100, 40, 64))


def wkv_forward(cs, rwkv6_wkv) -> dict:
    """The bf16 WKV forward at ``WKV_TIMED``: device ms, CUPTI busy ms, the
    bound and the route; then the compiled forward kernels at N = chunk =
    64."""
    import torch
    rows = {}
    route = getattr(rwkv6_wkv, "fwd_route", None)
    for shape in WKV_TIMED:
        args = cs.wkv_inputs(shape, "bfloat16")
        fn = lambda: rwkv6_wkv.rwkv6_wkv(*args)  # noqa: E731
        row = {"ms": cs.device_ms(fn),
               "busy_ms": cs.busy_ms(fn, f"rwkv6_wkv {shape}"),
               "route": route(*args[:4]) if route else "mma"}
        row.update(cs.wkv_bound(shape, 2))
        rows[f"rwkv6_wkv bfloat16 {shape}"] = row
    routes = ("mma", "wgmma") if route else ("mma",)
    for name in routes:
        info = rwkv6_wkv.kernel_info(64, 64, torch.bfloat16,
                                     *(("wgmma",) if name == "wgmma" else ()))
        rows[f"rwkv6_wkv {name} registers/spill/blocks/threads"] = [
            info["registers"], info["spill_bytes"], info["blocks_per_sm"],
            info["threads"]]
    return rows


WKV_BWD_TIMED = ((4, 512, 40, 64, False), (1, 512, 40, 64, False),
                 (2, 128, 3, 64, True), (4, 100, 40, 64, False))


def wkv_backward(cs, rwkv6_wkv) -> dict:
    """The bf16 WKV backward at ``WKV_BWD_TIMED`` (the third with w at both
    clamps) as the train step calls it: device ms, busy ms by kernel, the
    bound and the route; then the compiled backward kernels at N = chunk
    = 64 (the wgmma kernel where the tree has it, and the mma.sync route's
    chunk kernel and walk)."""
    import torch
    rows = {}
    route = getattr(rwkv6_wkv, "bwd_route", None)
    for *shape, clamped in WKV_BWD_TIMED:
        shape = tuple(shape)
        args, dout, _ = cs.scan_bwd_inputs("rwkv6_wkv", shape, "bfloat16",
                                           clamped)
        fn = lambda: rwkv6_wkv.rwkv6_wkv_bwd(*args, dout)  # noqa: E731
        parts = {}
        for key, _, ms in cs.traced_rows(fn, 10):
            found = cs.SCAN_BWD_KERNEL.search(key)
            if found:
                parts[found.group(1)] = parts.get(found.group(1), 0.0) \
                    + ms / 10
        row = {"ms": cs.device_ms(fn), "parts_busy_ms": parts,
               "busy_ms": sum(parts.values()),
               "route": route(*args[:4], dout) if route else "mma"}
        row.update(cs.wkv_bwd_bound(shape, 2))
        rows[f"rwkv6_wkv_bwd bfloat16 {shape}"
             + (" clamped" if clamped else "")] = row
    for part in ("wgmma", "chunk", "walk") if route else ("chunk", "walk"):
        info = rwkv6_wkv.bwd_kernel_info(64, 64, torch.bfloat16, part)
        rows[f"rwkv6_wkv_bwd {part} registers/spill/blocks/threads"] = [
            info["registers"], info["spill_bytes"], info["blocks_per_sm"],
            info["threads"]]
    return rows


def ssd_backward(cs, mamba2_ssd) -> dict:
    """The bf16 SSD backward at ``SSD_TIMED`` as the train step calls
    it: device ms, busy ms by kernel, the bound and the route; then the
    compiled backward kernels at N = P = chunk = 64 (the cluster kernel
    where the tree has it, and the mma.sync route's chunk kernel and
    walk)."""
    import torch
    rows = {}
    route = getattr(mamba2_ssd, "bwd_route", None)
    for shape in SSD_TIMED:
        args, dout, _ = cs.scan_bwd_inputs("mamba2_ssd", shape, "bfloat16")
        fn = lambda: mamba2_ssd.mamba2_ssd_bwd(*args, dout)  # noqa: E731
        parts = {}
        for key, _, ms in cs.traced_rows(fn, 10):
            found = cs.SCAN_BWD_KERNEL.search(key)
            if found:
                parts[found.group(1)] = parts.get(found.group(1), 0.0) \
                    + ms / 10
        row = {"ms": cs.device_ms(fn), "parts_busy_ms": parts,
               "busy_ms": sum(parts.values()),
               "route": (route(args[0], args[3], args[4], dout) if route
                         else "mma.sync")}
        row.update(cs.ssd_bwd_bound(shape, 2))
        rows[f"mamba2_ssd_bwd bfloat16 {shape}"] = row
    parts = ("cluster", "chunk", "walk") if route else ("chunk", "walk")
    for part in parts:
        info = mamba2_ssd.bwd_kernel_info(64, 64, 64, torch.bfloat16, part)
        rows[f"mamba2_ssd_bwd {part} registers/spill/blocks/threads"] = [
            info["registers"], info["spill_bytes"], info["blocks_per_sm"],
            info["threads"]]
    return rows



NORM_TIMED = ((8192, 4096), (1024, 4096), (4, 4096))
L2_BYTES = 50 * 2 ** 20


def norm_timing(cs, rms_norm) -> dict:
    """The fused norm and the plain chain at ``NORM_TIMED``, with and
    without the add, in turns on inputs that leave the L2 cold; then the
    compiled kernel at each shape (module docstring)."""
    import itertools
    import torch
    rows = {}
    for shape in NORM_TIMED:
        n, d = shape
        # x and delta of a call; enough of them to fill the L2 four times
        n_sets = max(2, -(-4 * L2_BYTES // (4 * n * d)))
        gen = torch.Generator(device="cuda").manual_seed(0)
        sets = [tuple(torch.randn(n, d, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2)) for _ in range(n_sets)]
        scale = torch.rand(d, generator=gen, device="cuda") + 0.5
        for with_delta in (True, False):
            cycle = itertools.cycle(sets)

            def fused():
                x, delta = next(cycle)
                if with_delta:
                    return rms_norm.add_rms_norm(x, delta, scale, 1e-5)
                return rms_norm.rms_norm(x, scale, 1e-5)

            def plain():
                x, delta = next(cycle)
                return rms_norm.rms_norm_plain(
                    x + delta if with_delta else x, scale, 1e-5)
            x0, d0 = sets[0]
            route = rms_norm.fwd_route(x0, scale, d0 if with_delta else None)
            assert route == "fused", route
            times = {"fused": [], "plain": []}
            for name in ("fused", "plain", "plain", "fused"):
                times[name].append(cs.device_ms(
                    fused if name == "fused" else plain))
            row = {"fused_ms": times["fused"], "plain_ms": times["plain"],
                   "fused_busy_ms": cs.busy_ms(fused, f"rms_norm {shape}"),
                   "plain_busy_ms": cs.busy_ms(plain, f"chain {shape}"),
                   "inputs": n_sets}
            row.update(cs.norm_bound(shape, 2, with_delta))
            row["hbm_bound_share"] = row["bound_ms"] / max(times["fused"])
            rows[f"rms_norm {shape} delta={with_delta}"] = row
            info = rms_norm.kernel_info(n, d, with_delta)
            rows[f"rms_norm {shape} delta={with_delta} "
                 f"registers/spill/blocks/threads"] = [
                info["registers"], info["spill_bytes"],
                info["blocks_per_sm"], info["threads"]]
        del sets
    return rows


if __name__ == "__main__":
    main()
