"""Optimizers of the port (the slice's subset of ``paddle_tpu/optimizer``)."""
from paddle_tpu_torch.optimizer.optimizers import Adam, Optimizer  # noqa: F401
