"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. CUDA sources live in ``csrc/`` and are built by :mod:`._build`
on first use; nothing is compiled when a module is imported."""

import torch


def refuse_grad(name: str, *inputs: torch.Tensor) -> None:
    """Raise when autograd would need a backward through ``name``'s CUDA
    route. The route fills outputs it allocated through ctypes, so they
    carry no ``grad_fn``: a train step would get no gradient through the
    kernel, and nothing would fail. Flash attention has its backward
    kernel (``flash_attention_bwd``); the SSD and WKV scans keep this check
    until theirs are written (ROADMAP.md A12b-2). The CPU plain versions
    are torch ops and keep autograd."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward kernel yet (the "
            f"hand-written backward kernels of mamba2_ssd and rwkv6_wkv are "
            f"the next slice, ROADMAP.md A12b-2), and an input requires "
            f"grad; call it under torch.no_grad() or detach the inputs")


# the model's kernels, by the name the serve and train stats record
# (imported after refuse_grad, which the scan modules import from here;
# as modules, so the package's attributes stay its submodules)
from . import flash_attention as _flash  # noqa: E402
from . import mamba2_ssd as _ssd  # noqa: E402
from . import rwkv6_wkv as _wkv  # noqa: E402

KERNELS = {"flash_attention": _flash.flash_attention,
           "flash_attention_bwd": _flash.flash_attention_bwd,
           "mamba2_ssd": _ssd.mamba2_ssd, "rwkv6_wkv": _wkv.rwkv6_wkv}
