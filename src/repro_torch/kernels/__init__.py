"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. CUDA sources live in ``csrc/`` and are built by :mod:`._build`
on first use; nothing is compiled when a module is imported."""
