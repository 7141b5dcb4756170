"""Serving a mixture-of-experts model on the PyTorch port under EnTK.

Serves ``--arch`` (dbrx-132b: every layer MoE, top-4 of 16 experts;
llama4-maverick-400b-a17b: dense and MoE layers in turn, top-1 of 128
with a shared expert) at its smoke widths, or at its published widths
with ``--full``: a few EnTK request batches, each a prefill of the prompts
and greedy decode, with random weights drawn on the device from seed 0.
Prefill runs the attention through the CUDA ``flash_attention`` kernel
(one launch a layer; on the CPU its plain version runs and nothing is
launched), and each MoE layer routes every token to its top-k experts
with the capacity dispatch of :mod:`repro_torch.models.moe`. Prints the
parameter counts (total and active), each batch's launches and timings,
and the generated tokens.

    PYTHONPATH=src python examples/torch_serve_moe.py --device cpu
    PYTHONPATH=src python examples/torch_serve_moe.py --device cpu \
        --arch llama4-maverick-400b-a17b
"""

import argparse
import time

import numpy as np

from repro_torch.launch import serve
from repro_torch.models.config import get_config
from repro_torch.models.moe import capacity


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dbrx-132b",
                    choices=["dbrx-132b", "llama4-maverick-400b-a17b"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke config)")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=8)
    args = ap.parse_args()
    cfg = get_config(args.arch, smoke=not args.full)
    tokens = args.batch_size * args.prompt_len
    print(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_experts} experts (top-{cfg.experts_per_token}, every "
          f"{cfg.moe_layer_period} layer(s), shared expert "
          f"{cfg.moe_shared_expert}); {cfg.n_params()} parameters, "
          f"{cfg.n_active_params()} active; prefill capacity "
          f"{capacity(tokens, cfg)} tokens an expert")
    t0 = time.perf_counter()
    amgr = serve.run_managed(args.arch, n_batches=args.batches,
                             batch_size=args.batch_size,
                             prompt_len=args.prompt_len,
                             max_new_tokens=args.new_tokens,
                             smoke=not args.full, device=args.device)
    wall = time.perf_counter() - t0
    sess = serve.get_session(args.arch, not args.full, args.device)
    for rec in sess.stats[-args.batches:]:
        print(f"batch: prefill_s={rec['prefill_s']:.4f} decode_s_per_token="
              f"{rec['decode_s_per_token']:.4f} flash_attention_launches="
              f"{rec['flash_attention_launches']}")
    tasks = [t for p in amgr.workflow for s in p.stages for t in s.tasks]
    for t in tasks:
        out = np.asarray(t.result)
        print(f"{t.name}: tokens {out.tolist()}")
    print(f"wall seconds {wall:.2f}; all DONE: {amgr.all_done}")


if __name__ == "__main__":
    main()
