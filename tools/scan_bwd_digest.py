"""Digests of the SSD and WKV backward kernels' f32 route.

    python3 tools/scan_bwd_digest.py [--src DIR]

Runs the f32 route of ``mamba2_ssd_bwd`` and ``rwkv6_wkv_bwd`` at every
shape that ``chip_smoke.py`` holds to ``SCAN_BWD_F32_DIGEST``
(``SSD_BWD_SHAPES``, ``WKV_BWD_SHAPES``, ``WKV_BWD_CLAMPED``), on that
script's inputs, with the ``repro_torch`` package under ``DIR`` (default:
this checkout's ``src``), and prints the card and one JSON object:
``chip_smoke.scan_bwd_digest`` of each call's gradients, keyed as the
table is. Given an older checkout's ``src``, it gives the bits that
table holds the route to. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=os.path.join(HERE, "src"))
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke as smoke
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    cases = ([("mamba2_ssd", s, False) for s in smoke.SSD_BWD_SHAPES]
             + [("rwkv6_wkv", s, False) for s in smoke.WKV_BWD_SHAPES]
             + [("rwkv6_wkv", s, True) for s in smoke.WKV_BWD_CLAMPED])
    out = {}
    for name, shape, clamped in cases:
        bwd = smoke.scan_fns(name)[2]
        inputs, dout, dstate = smoke.scan_bwd_inputs(name, shape, "float32",
                                                     clamped)
        grads = bwd(*inputs, dout, dstate)
        torch.cuda.synchronize()
        out[repr((name, tuple(shape), clamped))] = smoke.scan_bwd_digest(
            grads)
    import repro_torch
    print(f"package: {os.path.dirname(repro_torch.__file__)}")
    print(smoke.card_line())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
