"""Activation ops (ref: ``paddle_tpu/ops/activations.py``), registered
under the reference's names and signatures.

Clipping is written ``minimum(maximum(x, lo), hi)``, as ``jnp.clip`` is,
so a value exactly at a bound takes the reference's split gradient (0.5);
``torch.clamp`` passes 1 there.
"""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op


def _full(x, value):
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: maximum, then minimum."""
    return torch.minimum(torch.maximum(x, _full(x, lo)), _full(x, hi))


@register_op("relu")
def relu(x):
    """``maximum(x, 0)``, as the reference writes it (ref:
    ``ops/activations.py:17``). Its gradient at exactly 0 is 0.5, the
    reference's (a max splits its gradient at a tie); ``torch.relu``'s is
    0, which bf16 batch-norm outputs, exactly 0 often, would show."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


@register_op("relu6")
def relu6(x, threshold=6.0):
    return _clip(x, 0.0, threshold)


@register_op("leaky_relu")
def leaky_relu(x, alpha=0.02):
    return torch.where(x >= 0, x, alpha * x)


@register_op("prelu")
def prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


@register_op("elu")
def elu(x, alpha=1.0):
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, alpha * (torch.exp(safe) - 1.0))


@register_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * elu(x, alpha)


@register_op("gelu")
def gelu(x, approximate=False):
    """Gelu; the exact erf form by default, as ``jax.nn.gelu(x,
    approximate=False)`` in the reference (``ops/activations.py:48``).
    The fused MLP kernel uses the same exact form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


@register_op("sigmoid")
def sigmoid(x):
    """ref: ``ops/activations.py:53`` (the RNN cells' gates)."""
    return torch.sigmoid(x)


@register_op("logsigmoid")
def logsigmoid(x):
    return F.logsigmoid(x)


@register_op("hard_sigmoid")
def hard_sigmoid(x, slope=0.2, offset=0.5):
    return _clip(slope * x + offset, 0.0, 1.0)


@register_op("tanh")
def tanh(x):
    """ref: ``ops/activations.py:68``."""
    return torch.tanh(x)


@register_op("tanh_shrink")
def tanh_shrink(x):
    return x - torch.tanh(x)


@register_op("hard_shrink")
def hard_shrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


@register_op("softshrink")
def softshrink(x, lambda_=0.5):
    return torch.sign(x) * torch.maximum(torch.abs(x) - lambda_, _full(x, 0.0))


@register_op("softplus")
def softplus(x):
    """``logaddexp(x, 0)``, as ``jax.nn.softplus`` (``F.softplus`` turns
    linear past a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@register_op("softsign")
def softsign(x):
    return x / (1.0 + torch.abs(x))


@register_op("swish")
def swish(x, beta=1.0):
    return x * torch.sigmoid(beta * x)


@register_op("silu")
def silu(x):
    return x * torch.sigmoid(x)


@register_op("hard_swish")
def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0):
    return x * _clip(x + offset, 0.0, threshold) / scale


@register_op("mish")
def mish(x):
    return x * torch.tanh(softplus(x))


@register_op("brelu")
def brelu(x, t_min=0.0, t_max=24.0):
    return _clip(x, t_min, t_max)


@register_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


@register_op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@register_op("softmax")
def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


@register_op("log_softmax")
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


@register_op("maxout")
def maxout(x, groups, axis=1):
    """ref: ``ops/activations.py:143``: the max over ``groups`` adjacent
    channels of ``axis``."""
    shape = list(x.shape)
    shape[axis] = x.shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), dim=axis + 1)
