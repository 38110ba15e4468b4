"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``), each
beside its plain PyTorch version."""
