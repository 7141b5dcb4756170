"""Adaptive Analog Ensemble on the PyTorch port (paper use case §III-B,
Fig. 11).

Runs the AUA (adaptive) and random-placement analog searches of
``repro_torch.apps.anen``, described as ``api.repeat_until`` loops over
``api.ensemble`` rounds, on :class:`~repro_torch.rts.torch_rts.TorchRTS`.
Each round runs as one DAG carrier (``analog_values → analog_refine →
max``) whose entry node launches the CUDA ``anen_distance`` kernel once;
on the CPU the kernel's plain version runs instead.

    PYTHONPATH=src python examples/torch_adaptive_anen.py [--repeats 3]
    PYTHONPATH=src python examples/torch_adaptive_anen.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.apps.anen.workflow import run_adaptive, run_random


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--per-iter", type=int, default=40)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    kw = dict(ny=args.grid, nx=args.grid, per_iter=args.per_iter,
              max_iters=args.iters, n_hist=100, device=args.device)
    aua_final, rnd_final = [], []
    for seed in range(args.repeats):
        a = run_adaptive(seed=seed, **kw)
        r = run_random(seed=seed, **kw)
        # the adaptive loop must actually have adapted: every round past the
        # first was appended at runtime by the repeat_until machinery
        assert a["all_done"] and r["all_done"], (a, r)
        assert a["rounds"] >= 2, f"no adaptive round ran: {a}"
        # and every round ran as one DAG carrier
        assert a["fusion_stats"]["dag_carriers"] == a["rounds"], a
        aua_final.append(a["final_rmse"])
        rnd_final.append(r["final_rmse"])
        print(f"seed {seed}:")
        print(f"  AUA    errors per iteration: "
              f"{[round(e, 4) for e in a['errors']]}")
        print(f"  random errors per iteration: "
              f"{[round(e, 4) for e in r['errors']]}")
        print(f"  dispatches a round: "
              f"{a['fusion_stats']['dispatches'] / a['rounds']}")

    print(f"\nover {args.repeats} repeats "
          f"({args.per_iter * args.iters} locations of "
          f"{args.grid * args.grid} pixels, device {args.device}):")
    print(f"  AUA    median RMSE: {np.median(aua_final):.4f}")
    print(f"  random median RMSE: {np.median(rnd_final):.4f}")
    wins = sum(a < r for a, r in zip(aua_final, rnd_final))
    print(f"  AUA wins {wins}/{args.repeats} "
          "(cf. paper Fig. 11d: adaptive converges faster)")


if __name__ == "__main__":
    main()
