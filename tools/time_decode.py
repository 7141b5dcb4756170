"""Time prefill and decode of one source tree on the card.

    python3 tools/time_decode.py --src PATH/src [--tokens 32] [--reps 3]

Builds the kernels of the tree under ``PATH`` (its own ``build/``), then
for minitron-4b (the attention stack), rwkv6-3b (the RWKV recurrence) and
zamba2-7b (Mamba-2 and the shared block) at their published widths,
random bf16 weights from seed 0: ``--reps`` times, a prefill of 4 x 512
seeded tokens and ``--tokens`` greedy decode steps through that tree's
``make_prefill_step`` / ``make_decode_step``, each step's host wall taken
around work that ends in ``torch.cuda.synchronize()``. It prints the card
and one JSON line: the prefill seconds and the decode seconds a token of
each repetition. Two trees compare when they run in turns on one card:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("minitron-4b", "rwkv6-3b", "zamba2-7b")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", required=True,
                        help="the tree's src directory (holds repro_torch)")
    parser.add_argument("--tokens", type=int, default=32)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.kernels import flash_attention, mamba2_ssd, rwkv6_wkv
    from repro_torch.models import steps, transformer
    from repro_torch.models.config import get_config
    for kmod in (flash_attention, mamba2_ssd, rwkv6_wkv):
        kmod.build()
    out = {"src": os.path.abspath(args.src)}
    for arch in ARCHS:
        cfg = get_config(arch)
        params = transformer.init_params(cfg, 0, torch.bfloat16, "cuda")
        prefill, decode = (steps.make_prefill_step(cfg),
                           steps.make_decode_step(cfg))
        gen = torch.Generator(device="cuda").manual_seed(0)
        prompt = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                               device="cuda", dtype=torch.int32)
        row = {"prefill_s": [], "decode_s_per_token": []}
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"inputs": prompt})
            torch.cuda.synchronize()
            row["prefill_s"].append(time.perf_counter() - t0)
            # decode into a cache with room for the new tokens
            full = transformer.init_cache(cfg, 4, 512 + args.tokens, "cuda")
            for key in ("k", "v"):
                if key in full:
                    full[key][:, :, :512].copy_(cache[key])
            for key in ("rwkv", "mamba"):
                if key in full:
                    full[key] = cache[key]
            full["length"] = cache["length"]
            del cache
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.tokens):
                logits, full = decode(params, tok, full)
                tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            row["decode_s_per_token"].append(
                (time.perf_counter() - t0) / args.tokens)
            del full
        out[arch] = row
        del params
        torch.cuda.empty_cache()
    print(cs.card_line())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
