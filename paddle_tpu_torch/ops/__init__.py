"""Ops of the port: plain PyTorch, with the hand-written kernels under
``ops/cuda``."""
