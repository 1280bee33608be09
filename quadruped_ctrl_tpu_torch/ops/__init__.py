"""Kernels of the port: hand-written CUDA for Hopper and their plain PyTorch references."""
