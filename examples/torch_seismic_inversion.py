"""Seismic FWI mini-campaign on the PyTorch port (paper use case §III-A)
under EnTK.

1. "Observe": forward-simulate an ensemble of earthquakes on the true
   velocity model (EnTK stage of concurrent forward tasks, with injected
   failures + automatic resubmission — the Fig. 10 scenario).
2. Invert: a few adjoint-gradient iterations on a smooth starting model,
   each iteration an EnTK stage of per-event gradient tasks (autograd
   through the time loop) whose results are summed into a model update.
3. Evaluate the final model with the fused misfit sweep: the
   forward→misfit chain with its Σ gather, one DAG carrier on TorchRTS.

    PYTHONPATH=src python examples/torch_seismic_inversion.py
    PYTHONPATH=src python examples/torch_seismic_inversion.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.apps.seismic.solver import (SeismicConfig,
                                             forward_simulation,
                                             make_velocity_model,
                                             misfit_and_grad)
from repro_torch.apps.seismic.workflow import run_misfit_chain
from repro_torch.core import (AppManager, Pipeline, Stage, Task,
                              register_executable)
from repro_torch.fusion.handles import to_host
from repro_torch.rts.base import ResourceDescription
from repro_torch.rts.local import LocalRTS

CFG = SeismicConfig(nx=64, nz=64, nt=140, n_receivers=16)
_STATE = {}


def observe_task(source_x: int):
    seis = forward_simulation(_STATE["v_true"], source_x, CFG)
    return {"source_x": source_x, "seis": to_host(seis).tolist()}


def gradient_task(source_x: int):
    obs = _STATE["observed"][source_x]
    m, g = misfit_and_grad(_STATE["v_current"], obs, source_x, CFG)
    return {"misfit": float(m), "grad": to_host(g).tolist()}


register_executable("fwi_observe", observe_task)
register_executable("fwi_gradient", gradient_task)


def run_stage(tasks, slots=4, failure_rate=0.0):
    rng = np.random.default_rng(0)
    amgr = AppManager(
        resources=ResourceDescription(slots=slots),
        rts_factory=lambda: LocalRTS(
            fault_injector=lambda t: rng.random() < failure_rate))
    pipe = Pipeline("fwi")
    st = Stage()
    st.add_tasks(tasks)
    pipe.add_stages(st)
    amgr.workflow = [pipe]
    amgr.run(timeout=1800)
    assert amgr.all_done, "stage failed"
    return [t.result for t in st.tasks]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    sources = [12, 24, 36, 48]
    _STATE["v_true"] = make_velocity_model(CFG, "true", device=dev)

    print("stage 1: observing (forward ensemble, 30% injected failures)")
    results = run_stage(
        [Task(name=f"obs{sx}", executable="reg://fwi_observe",
              kwargs={"source_x": sx}, max_retries=5) for sx in sources],
        failure_rate=0.3)
    _STATE["observed"] = {
        r["source_x"]: torch.tensor(r["seis"], dtype=torch.float32,
                                    device=_STATE["v_true"].device)
        for r in results}

    v = make_velocity_model(CFG, "background", device=dev)
    print("stage 2: adjoint inversion iterations (backtracking steps)")
    eps = 4.0  # m/s perturbation along the normalized gradient
    prev = None
    for it in range(4):
        _STATE["v_current"] = v
        grads = run_stage(
            [Task(name=f"grad{it}-{sx}", executable="reg://fwi_gradient",
                  kwargs={"source_x": sx}, max_retries=2)
             for sx in sources])
        total_misfit = sum(g["misfit"] for g in grads)
        if prev is not None and total_misfit > prev:
            eps *= 0.3  # overshoot: backtrack
        prev = total_misfit
        g_sum = torch.tensor(
            np.sum([np.asarray(g["grad"]) for g in grads], axis=0),
            dtype=torch.float32, device=v.device)
        g_norm = g_sum / max(1e-12, float(g_sum.abs().max()))
        v = v - eps * g_norm
        err = float((v - _STATE["v_true"]).abs().mean())
        print(f"  iter {it}: misfit {total_misfit:10.5f}  "
              f"model error {err:8.3f} m/s  (step {eps:.2f} m/s)")

    print("stage 3: fused misfit sweep (forward -> misfit -> sum, one DAG "
          "carrier)")
    sweep = run_misfit_chain(16, nx=64, nt=140, dv=25.0, device=dev)
    assert sweep["all_done"]
    print(f"  total misfit {sweep['total_misfit']:.6f} over 16 sources; "
          f"dag_carriers {sweep['fusion_stats']['dag_carriers']}, "
          f"dispatches {sweep['fusion_stats']['dispatches']}")
    print("done — misfit decreased via EnTK-managed adjoint ensembles")


if __name__ == "__main__":
    main()
