"""Activation ops (the slice's subset of ``paddle_tpu/ops/activations.py``)."""

import torch


def relu(x):
    """ref: ``ops/activations.py:17`` (the Transformer's FFN)."""
    return torch.relu(x)


def sigmoid(x):
    """ref: ``ops/activations.py:53`` (the RNN cells' gates)."""
    return torch.sigmoid(x)


def gelu(x, approximate=False):
    """Gelu; the exact erf form by default, as ``jax.nn.gelu(x,
    approximate=False)`` in the reference (``ops/activations.py:48``).
    The fused MLP kernel uses the same exact form."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x):
    """ref: ``ops/activations.py:68``."""
    return torch.tanh(x)
