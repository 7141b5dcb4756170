"""Use-case applications from the paper (§III), implemented in PyTorch."""
