"""Kernels (hand-written CUDA under csrc/) and their plain PyTorch versions."""
