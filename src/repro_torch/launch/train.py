"""Training launcher: EnTK-managed, checkpointed LM training on one device.

The run is expressed as an EnTK pipeline (the paper's PST model):

    Pipeline[ Stage(chunk_0) → … → Stage(chunk_k) ]

Each *chunk task* (``reg://train_chunk``, run by
:class:`~repro_torch.rts.torch_rts.TorchRTS`) trains ``steps_per_chunk``
steps from the latest checkpoint and writes a new one. Failure anywhere
(task crash, injected fault) is handled by the toolkit's resubmission
path, and the resubmitted chunk resumes from the checkpoint: completed
work is never repeated, as in the JAX package.

On the card a step runs the forward and backward CUDA kernels of its
family's layers: flash attention (the attention stack, zamba2's shared
block), the Mamba-2 SSD scan (hybrid) and the RWKV-6 WKV recurrence
(ssm). ``grad_compression="int8"`` allocates the int8 error-feedback
state (:mod:`~repro_torch.optim.compression`) at the first ``run_steps``,
as the JAX trainer does; neither wires it into the step.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --managed
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core import AppManager, Pipeline, Stage, Task, register_executable
from ..data import Prefetcher, make_stream
from ..device import DeviceLike, device_name, resolve_device
from ..kernels import KERNELS
from ..models import steps as steps_mod
from ..models.config import get_config
from ..optim import compression
from ..optim.adamw import AdamWConfig
from ..rts.base import ResourceDescription
from ..rts.torch_rts import TorchRTS


_SESSIONS: Dict[str, "TrainSession"] = {}
_SESSIONS_LOCK = threading.Lock()


class TrainSession:
    """One training run's state and step function on one device. With no
    ``ckpt_dir`` the state lives in memory only. ``stats`` keeps one
    record a step: its global index, loss, grad norm, wall seconds and
    each kernel's launches (the change of the wrappers' global counts over
    the step: exact when one step runs at a time on the device)."""

    def __init__(self, arch: str, smoke: bool, seq_len: int,
                 global_batch: int, ckpt_dir: Optional[str] = None,
                 grad_compression: Optional[str] = None,
                 lr: float = 3e-4, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.cfg = get_config(arch, smoke=smoke)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.stream = make_stream(self.cfg, seq_len, global_batch)
        opt = AdamWConfig(lr=lr, warmup_steps=20, total_steps=100000)
        self.compression = grad_compression
        self._step_fn = steps_mod.make_train_step(self.cfg, opt)
        self.state = None
        self.step = 0
        self.error_state = None
        self.stats: List[Dict[str, Any]] = []

    def restore_or_init(self) -> int:
        latest = self.ckpt.latest() if self.ckpt is not None else None
        if latest is None:
            if self.state is None or self.ckpt is not None:
                self.state = steps_mod.init_train_state(self.cfg, 0,
                                                        self.device)
                self.step = 0
        elif self.state is None or self.step != latest:
            self.state = None       # free the old state before the restore
            abstract = steps_mod.abstract_train_state(self.cfg)
            self.state, self.step, _ = self.ckpt.restore(abstract,
                                                         device=self.device)
        return self.step

    def run_steps(self, n: int, save: bool = True) -> Dict[str, Any]:
        self.restore_or_init()
        if self.compression == "int8" and self.error_state is None:
            self.error_state = compression.init_error(self.state["params"])
        pf = Prefetcher(self.stream, start_step=self.step)
        losses = []
        first = self.step
        try:
            for _ in range(n):
                step_idx, batch = pf.next()
                if step_idx != self.step:
                    raise RuntimeError(f"data stream at batch {step_idx}, "
                                       f"train state at step {self.step}")
                launches = {k: fn.launches for k, fn in KERNELS.items()}
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
                self.state, metrics = self._step_fn(self.state, batch)
                # the copy to the host waits for the whole step, AdamW too
                loss = float(metrics["loss"])
                self.stats.append({
                    "step": self.step, "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "seconds": time.perf_counter() - t0,
                    **{f"{k}_launches": fn.launches - launches[k]
                       for k, fn in KERNELS.items()}})
                losses.append(loss)
                self.step += 1
        finally:
            pf.stop()
        if save:
            if self.ckpt is None:
                raise ValueError("run_steps(save=True) needs a ckpt_dir")
            self.ckpt.save_async(self.step, self.state,
                                 extra={"loss": losses[-1]})
            self.ckpt.wait()
        return {"step": self.step, "first_step": first,
                "loss_first": losses[0], "loss_last": losses[-1],
                "loss_mean": float(np.mean(losses))}


def get_session(key: str, **kwargs: Any) -> TrainSession:
    """The process's session for ``key`` (the checkpoint directory), built
    once."""
    with _SESSIONS_LOCK:
        if key not in _SESSIONS:
            _SESSIONS[key] = TrainSession(**kwargs)
        return _SESSIONS[key]


def train_chunk(arch: str, smoke: bool, seq_len: int, global_batch: int,
                ckpt_dir: str, steps: int,
                grad_compression: Optional[str] = None,
                lr: float = 3e-4, fail_once_at: Optional[int] = None,
                device: Optional[str] = None) -> Dict[str, Any]:
    """EnTK task executable: train ``steps`` steps from the latest ckpt.

    ``fail_once_at``: testing hook — raise once when the global step passes
    this value (exercises the resubmission path; the retry resumes from the
    checkpoint)."""
    sess = get_session(ckpt_dir, arch=arch, smoke=smoke, seq_len=seq_len,
                       global_batch=global_batch, ckpt_dir=ckpt_dir,
                       grad_compression=grad_compression, lr=lr,
                       device=device)
    start = sess.restore_or_init()
    if fail_once_at is not None and start <= fail_once_at:
        flag = os.path.join(ckpt_dir, ".failed_once")
        if not os.path.exists(flag):
            with open(flag, "w") as fh:
                fh.write("x")
            raise RuntimeError(f"injected training fault at step {start}")
    return sess.run_steps(steps)


register_executable("train_chunk", train_chunk)


def build_training_pipeline(arch: str, *, smoke: bool, seq_len: int,
                            global_batch: int, ckpt_dir: str,
                            total_steps: int, steps_per_chunk: int,
                            max_retries: int = 2,
                            fail_once_at: Optional[int] = None,
                            device: DeviceLike = None) -> Pipeline:
    dev = device_name(device)
    pipe = Pipeline(f"train-{arch}")
    n_chunks = -(-total_steps // steps_per_chunk)
    for c in range(n_chunks):
        st = Stage(f"chunk{c}")
        steps = min(steps_per_chunk, total_steps - c * steps_per_chunk)
        st.add_tasks(Task(
            name=f"{arch}-chunk{c}",
            executable="reg://train_chunk",
            kwargs={"arch": arch, "smoke": smoke, "seq_len": seq_len,
                    "global_batch": global_batch, "ckpt_dir": ckpt_dir,
                    "steps": steps, "fail_once_at": fail_once_at,
                    "device": dev},
            max_retries=max_retries,
            duration_hint=steps * 2.0,
        ))
        pipe.add_stages(st)
    return pipe


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "entk-train-torch")


def run_managed(arch: str, *, smoke: bool = True, seq_len: int = 128,
                global_batch: int = 8, total_steps: int = 20,
                steps_per_chunk: int = 5, ckpt_dir: Optional[str] = None,
                fail_once_at: Optional[int] = None,
                timeout: float = 3600.0,
                device: DeviceLike = None) -> AppManager:
    """Run a training pipeline under the full EnTK stack on one device
    (``cuda`` unless ``device="cpu"``); returns the AppManager (overheads
    in ``.prof``, states in ``.state_table``, the chunks' results on their
    tasks)."""
    dev = device_name(device)
    ckpt_dir = ckpt_dir or default_ckpt_dir()
    os.makedirs(ckpt_dir, exist_ok=True)
    amgr = AppManager(
        resources=ResourceDescription(slots=1),
        rts_factory=lambda: TorchRTS(device=dev),
        journal_path=os.path.join(ckpt_dir, "journal.jsonl"),
    )
    amgr.workflow = [build_training_pipeline(
        arch, smoke=smoke, seq_len=seq_len, global_batch=global_batch,
        ckpt_dir=ckpt_dir, total_steps=total_steps,
        steps_per_chunk=steps_per_chunk, fail_once_at=fail_once_at,
        device=dev)]
    amgr.run(timeout=timeout)
    return amgr


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--steps-per-chunk", type=int, default=5)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: entk-train-torch in the temp directory")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--managed", action="store_true",
                    help="run through the EnTK stack (default: direct loop)")
    args = ap.parse_args()
    ckpt_dir = args.ckpt_dir or default_ckpt_dir()

    if args.managed:
        t0 = time.time()
        amgr = run_managed(args.arch, smoke=args.smoke,
                           seq_len=args.seq_len, global_batch=args.batch,
                           total_steps=args.steps,
                           steps_per_chunk=args.steps_per_chunk,
                           ckpt_dir=ckpt_dir, device=args.device)
        print(f"managed run done in {time.time()-t0:.1f}s; "
              f"all tasks DONE: {amgr.all_done}")
        for cat, secs in sorted(amgr.prof.totals().items()):
            print(f"  {cat}: {secs:.3f}s")
    else:
        sess = get_session(ckpt_dir, arch=args.arch, smoke=args.smoke,
                           seq_len=args.seq_len, global_batch=args.batch,
                           ckpt_dir=ckpt_dir, device=args.device)
        out = sess.run_steps(args.steps)
        print(out)


if __name__ == "__main__":
    main()
