"""Time the full-width qwen2-vl-2b train step of one source tree on the card.

    python3 tools/time_train_step.py --src PATH/src [--steps 5]

Builds the kernels of the tree under ``PATH`` (its own ``build/``), runs
``chip_smoke.py``'s first train run (``TRAIN_RUNS[0]``: qwen2-vl-2b at full
width and depth, 4 x 512, f32 masters and AdamW) through that tree's
``TrainSession`` for ``--steps`` steps, the first of them cold, then one
more step under the profiler (``chip_smoke.profile_train_step``: wall,
device busy ms and busy ms by kind, the flash backward's among them). It
prints the card and one JSON line with the warm step seconds and tokens a
second. Two trees compare when they run in turns on one card: parent,
change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", required=True,
                        help="the tree's src directory (holds repro_torch)")
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.train import TrainSession
    flash_attention.build()

    train = cs.TRAIN_RUNS[0]               # qwen2-vl-2b, 4 x 512
    sess = TrainSession(arch=train["arch"], smoke=False,
                        seq_len=train["seq_len"],
                        global_batch=train["global_batch"], device="cuda")
    sess.restore_or_init()
    sess.run_steps(args.steps, save=False)
    warm = [rec["seconds"] for rec in sess.stats[1:]]
    tokens = train["seq_len"] * train["global_batch"]
    cs.profile_train_step(sess)
    print(cs.card_line())
    print(json.dumps({"src": os.path.abspath(args.src),
                      "warm_step_s": warm,
                      "tokens_per_s": [tokens / w for w in warm],
                      "loss": [rec["loss"] for rec in sess.stats]}))


if __name__ == "__main__":
    main()
