"""The benchmark of the PyTorch and CUDA port; see ``perfbench/run.py``."""
