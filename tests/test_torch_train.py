"""The port's trainer (``repro_torch.launch.train``) on the CPU:
the EnTK-managed, checkpointed run over ``TorchRTS(device="cpu")`` at
smoke size with an injected fault, as the JAX package's trainer runs it
over ``JaxRTS``; and the entry points' device rules.

The managed run trains minitron-4b's smoke configuration (the CLI's
default architecture) for 6 steps in chunks of 2 with ``fail_once_at=2``:
as in the JAX trainer, the hook fires in the first chunk that starts at or
before that step (here the first), before it trains. The toolkit
resubmits it, the retry starts from the newest checkpoint (none yet: step
0), the later chunks resume from theirs, and no step is trained twice.
"""

import json
import os

import pytest
import torch

from repro_torch.core.pst import resolve_executable
from repro_torch.launch import train


@pytest.fixture
def fresh_sessions():
    train._SESSIONS.clear()
    yield
    train._SESSIONS.clear()


def test_managed_run_survives_an_injected_fault(tmp_path, fresh_sessions):
    ckpt = str(tmp_path / "ckpt")
    amgr = train.run_managed("minitron-4b", smoke=True, seq_len=32,
                             global_batch=4, total_steps=6,
                             steps_per_chunk=2, ckpt_dir=ckpt,
                             fail_once_at=2, timeout=300.0, device="cpu")
    tasks = [t for p in amgr.workflow for s in p.stages for t in s.tasks]
    assert amgr.all_done
    assert [t.retries for t in tasks] == [1, 0, 0]
    results = [t.result for t in tasks]
    assert [r["first_step"] for r in results] == [0, 2, 4]
    assert [r["step"] for r in results] == [2, 4, 6]
    sess = train.get_session(ckpt)
    assert [rec["step"] for rec in sess.stats] == list(range(6))
    assert all(rec["loss"] == rec["loss"] and rec["grad_norm"] > 0
               for rec in sess.stats)
    assert sess.step == 6 and sess.ckpt.latest() == 6
    assert os.path.exists(os.path.join(ckpt, ".failed_once"))
    with open(os.path.join(ckpt, "journal.jsonl")) as fh:
        assert [json.loads(line) for line in fh]
    assert all(p.device.type == "cpu"
               for p in train.steps_mod.leaves(sess.state["params"]))


def test_a_new_session_resumes_from_the_checkpoint(tmp_path, fresh_sessions):
    """A process that restarts (a new session on the same directory)
    restores the newest checkpoint and continues the data stream there."""
    ckpt = str(tmp_path / "ckpt")
    kw = dict(arch="qwen2-vl-2b", smoke=True, seq_len=16, global_batch=2,
              ckpt_dir=ckpt, device="cpu")
    first = train.TrainSession(**kw)
    out = first.run_steps(2)
    assert out["step"] == 2 and out["first_step"] == 0
    second = train.TrainSession(**kw)
    assert second.restore_or_init() == 2
    for a, b in zip(train.steps_mod.leaves(second.state),
                    train.steps_mod.leaves(first.state)):
        assert torch.equal(a, b)
    out = second.run_steps(1)
    assert out["step"] == 3 and [r["step"] for r in second.stats] == [2]


def test_train_chunk_is_registered():
    assert resolve_executable("reg://train_chunk") is train.train_chunk


def test_grad_compression_is_refused_by_name(tmp_path, fresh_sessions):
    """``grad_compression="int8"`` is accepted, as by the JAX trainer: the
    first ``run_steps`` allocates a zero f32 error state of the parameters'
    shapes, and the losses equal an uncompressed run's (the step does not
    use the state, as in the JAX package). ``train_chunk`` passes it on."""
    kw = dict(arch="minitron-4b", smoke=True, seq_len=16, global_batch=2,
              device="cpu")
    plain = train.TrainSession(**kw)
    comp = train.TrainSession(grad_compression="int8", **kw)
    assert comp.error_state is None
    out_plain = plain.run_steps(2, save=False)
    out_comp = comp.run_steps(2, save=False)
    assert [r["loss"] for r in comp.stats] == [r["loss"] for r in
                                                plain.stats]
    assert out_comp["loss_last"] == out_plain["loss_last"]
    assert plain.error_state is None
    params = train.steps_mod.leaves(comp.state["params"])
    errors = train.steps_mod.leaves(comp.error_state)
    assert len(errors) == len(params)
    for e, p in zip(errors, params):
        assert e.dtype == torch.float32 and e.shape == p.shape
        assert e.device == p.device and not e.any()
    ckpt = str(tmp_path / "ckpt")
    train.train_chunk("minitron-4b", True, 16, 2, ckpt, 1,
                      grad_compression="int8", device="cpu")
    sess = train.get_session(ckpt)
    assert sess.compression == "int8" and sess.error_state is not None


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    for call in (lambda: train.TrainSession("minitron-4b", True, 16, 2),
                 lambda: train.run_managed("minitron-4b",
                                           ckpt_dir=str(tmp_path)),
                 lambda: train.build_training_pipeline(
                     "minitron-4b", smoke=True, seq_len=16, global_batch=2,
                     ckpt_dir=str(tmp_path), total_steps=2,
                     steps_per_chunk=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
