"""Activation ops (the port's subset of ``paddle_tpu/ops/activations.py``)."""

import torch


def relu(x):
    """``maximum(x, 0)``, as the reference writes it (ref:
    ``ops/activations.py:17``). Its gradient at exactly 0 is 0.5, the
    reference's (a max splits its gradient at a tie); ``torch.relu``'s is
    0, which bf16 batch-norm outputs, exactly 0 often, would show."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


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
