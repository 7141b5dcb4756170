"""Train a ~100M-parameter LM under full EnTK management on the PyTorch
port.

The run is a PST pipeline of train-chunk tasks over ``TorchRTS`` (each
trains N steps from the latest checkpoint and writes a new one); the
toolkit provides fault tolerance: ``--inject-fault`` makes one chunk crash
before it trains, EnTK resubmits it, and the retry resumes from the
checkpoint without repeating completed work. On the card each step's
attention runs the flash forward and backward CUDA kernels.

    PYTHONPATH=src python examples/torch_train_ensemble.py
    PYTHONPATH=src python examples/torch_train_ensemble.py --device cpu \\
        --steps 6 --steps-per-chunk 2 --seq-len 64 --batch 2 --fresh

~100M config: d_model=640, 10 layers, vocab 32000 (≈106M params).
"""

import argparse
import os
import shutil
import tempfile
import time

from repro_torch.models.config import ModelConfig, register_arch
from repro_torch.models.transformer import count_params


def _lm100m() -> ModelConfig:
    return ModelConfig(
        name="lm100m", family="dense", n_layers=10, d_model=640,
        n_heads=10, n_kv_heads=5, d_ff=2560, vocab_size=32000,
        rope_variant="standard")


register_arch("lm100m", _lm100m, _lm100m)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--steps-per-chunk", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "entk-train-100m-torch"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--inject-fault", action="store_true")
    ap.add_argument("--fresh", action="store_true",
                    help="delete the checkpoint dir first")
    args = ap.parse_args()

    if args.fresh and os.path.isdir(args.ckpt_dir):
        shutil.rmtree(args.ckpt_dir)

    from repro_torch.launch.train import run_managed
    cfg = _lm100m()
    print(f"model: {cfg.name} ≈{count_params(cfg)/1e6:.0f}M params on "
          f"{args.device}")
    print(f"training {args.steps} steps in chunks of "
          f"{args.steps_per_chunk} (seq {args.seq_len}, batch {args.batch})")

    t0 = time.time()
    amgr = run_managed(
        "lm100m", smoke=False, seq_len=args.seq_len,
        global_batch=args.batch, total_steps=args.steps,
        steps_per_chunk=args.steps_per_chunk, ckpt_dir=args.ckpt_dir,
        fail_once_at=(args.steps_per_chunk if args.inject_fault else None),
        timeout=24 * 3600, device=args.device)
    elapsed = time.time() - t0

    print(f"\nall chunks DONE: {amgr.all_done}  ({elapsed:.0f} s)")
    results = [t.result for p in amgr.workflow for s in p.stages
               for t in s.tasks if t.result]
    for r in results:
        print(f"  step {r['step']:4d}: loss {r['loss_last']:.4f}")
    retries = sum(t.retries for p in amgr.workflow for s in p.stages
                  for t in s.tasks)
    if args.inject_fault:
        print(f"injected fault recovered via resubmission "
              f"(total retries: {retries})")
    first = results[0]["loss_first"] if results else float("nan")
    last = results[-1]["loss_last"] if results else float("nan")
    print(f"loss: {first:.3f} → {last:.3f}")
    tok_s = args.steps * args.seq_len * args.batch / elapsed
    print(f"throughput ≈ {tok_s:,.0f} tokens/s on {args.device}")


if __name__ == "__main__":
    main()
