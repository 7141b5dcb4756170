"""The MoE family's training outside the f32 parity of
``test_torch_train_step_moe.py``: one bf16 step (the working precision)
against the JAX package's at the model tolerance, ``TrainSession`` on the
MoE smoke configurations with a checkpoint and a resume, and the aux loss
at exactly 0 for the families without experts."""

import numpy as np
import pytest
import torch

from _torch_train import batch_np, check_bf16_step, to_torch
from repro_torch.models import steps as tsteps
from repro_torch.models.config import get_config as tconfig

ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_within_model_tolerance(arch):
    check_bf16_step(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_session_runs_the_moe_smoke_configurations(arch, tmp_path):
    """The launcher needs no family switch: ``TrainSession`` trains the
    MoE smoke configurations and checkpoints them, and a second session
    resumes from the checkpoint."""
    from repro_torch.launch.train import TrainSession
    kw = dict(arch=arch, smoke=True, seq_len=16, global_batch=2,
              ckpt_dir=str(tmp_path), device="cpu")
    first = TrainSession(**kw)
    out = first.run_steps(2)
    assert out["step"] == 2
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in first.stats)
    second = TrainSession(**kw)
    assert second.restore_or_init() == 2
    second.run_steps(1)
    assert [r["step"] for r in second.stats] == [2]


@pytest.mark.parametrize("arch", ["minitron-4b", "zamba2-7b", "rwkv6-3b"])
def test_aux_loss_is_zero_without_experts(arch):
    cfg = tconfig(arch, smoke=True)
    params = tsteps.init_train_state(cfg, 0, "cpu")["params"]
    with torch.no_grad():
        loss, metrics = tsteps.loss_fn(params, cfg, to_torch(batch_np(arch)))
    assert float(metrics["aux"]) == 0.0
    assert float(loss) == float(metrics["ce"])
