"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. CUDA sources live in ``csrc/`` and are built by :mod:`._build`
on first use; nothing is compiled when a module is imported."""

import torch


def refuse_grad(name: str, *inputs: torch.Tensor) -> None:
    """Raise when autograd would need a backward through ``name``'s CUDA
    route. The route fills outputs it allocated through ctypes, so they
    carry no ``grad_fn``: a train step would get no gradient through the
    kernel, and nothing would fail. Each kernel takes this check out when it
    gains an ``autograd.Function`` with a backward. The CPU plain versions
    are torch ops and keep autograd."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet, and an input "
            f"requires grad; call it under torch.no_grad() or detach the "
            f"inputs")
