"""Plain float32 references of the benchmark's models, in PyTorch. They
import nothing of the program under test.

A configuration file names its reference (``"reference": "<module>"``), a
module of this package that gives:

- ``param_spec(cfg)``: (path, shape, init, init args, matmul weight) of
  every leaf, in the program's layout;
- ``vocab_size(cfg)``: the rows of the embedding, which token ids index;
- ``last_logits(params, cfg, ids, rnd=None)``: the logits at the last
  position of each row, with ``rnd`` the control's rounding or None;
- ``program_sizes(port_cfg)``: the program's model config read as the
  configuration file's keys, to hold the program to the file;
- ``forward_flops(cfg, batch, seq, head_tokens)``: the model FLOPs of one
  forward pass.
"""

from __future__ import annotations

import importlib

import torch


def load(name: str):
    """The reference module a configuration file names."""
    return importlib.import_module(f"{__name__}.{name}")


def exact_f32() -> None:
    """float32 matmuls in full float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
