"""Fake-quantization primitives with straight-through gradients, and the
real int quantization the weight-only transform uses (ref:
``paddle_tpu/quant/ops.py``).

The arithmetic is the reference's, step for step, so that the int8
values of :func:`quantize_to_int` are bit-equal to it:
``round(x * (bound / s))`` (not ``x / step``), rounding half to even, as
``jnp.round`` and ``torch.round`` both do. :func:`fake_quant_dequant` is
a ``torch.autograd.Function`` with the reference's saturating
straight-through backward: the gradient passes to ``x`` where ``|x| <=
scale`` and is 0 elsewhere; the scale takes a zero gradient.
"""

import torch


def qrange(bits):
    """Symmetric signed range ``[-bound, bound]``, ``bound = 2^(bits-1) -
    1``."""
    return float(2 ** (bits - 1) - 1)


def abs_max_scale(x, channel_axis=None):
    """Per-tensor (or per-channel over ``channel_axis``) abs-max scale
    (ref: ``quant/ops.py:28``)."""
    x = torch.as_tensor(x)
    if channel_axis is None:
        return x.abs().max()
    axes = tuple(i for i in range(x.ndim) if i != channel_axis)
    return x.abs().amax(dim=axes)


def _broadcast_scale(scale, x, channel_axis):
    scale = torch.as_tensor(scale)
    if channel_axis is None or scale.ndim == 0:
        return scale
    shape = [1] * x.ndim
    shape[channel_axis] = scale.shape[0]
    return scale.reshape(shape)


class _FakeQuantDequant(torch.autograd.Function):
    """``clip(round(x / step), -bound, bound) * step``, ``step = max(s,
    1e-8) / bound``; backward ``dy * (|x| <= s)`` and a zero gradient for
    the scale (ref: ``quant/ops.py:56-72``)."""

    @staticmethod
    def forward(ctx, x, scale, bits, channel_axis):
        bound = qrange(bits)
        s = _broadcast_scale(scale, x, channel_axis)
        s = torch.clamp(s, min=1e-8)
        step = s / bound
        q = torch.clamp(torch.round(x / step), -bound, bound)
        ctx.save_for_backward((x.abs() <= s).to(x.dtype))
        ctx.scale_like = (scale.shape, scale.dtype, scale.device)
        return q * step

    @staticmethod
    def backward(ctx, dy):
        (mask,) = ctx.saved_tensors
        shape, dtype, device = ctx.scale_like
        return (dy * mask, torch.zeros(shape, dtype=dtype, device=device),
                None, None)


def fake_quant_dequant(x, scale, bits=8, channel_axis=None):
    """Simulated int quantization of ``x`` at ``scale`` (per tensor, or per
    channel of ``channel_axis``), with the saturating straight-through
    gradient."""
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    return _FakeQuantDequant.apply(x, scale, bits, channel_axis)


def fake_quant_abs_max(x, bits=8, channel_axis=None):
    """Dynamic abs-max fake quant: the scale is recomputed from the live
    tensor and takes no gradient (ref: ``quant/ops.py:75``)."""
    scale = abs_max_scale(x.detach(), channel_axis)
    return fake_quant_dequant(x, scale, bits, channel_axis)


def moving_average_scale(prev_scale, x, rate=0.9):
    """``rate * prev + (1 - rate) * abs_max(x)`` (ref:
    ``quant/ops.py:84``)."""
    return rate * torch.as_tensor(prev_scale) + (1.0 - rate) * \
        abs_max_scale(x)


def range_abs_max_scale(prev_scale, x, step, window_size=10000):
    """Windowed running max: the live abs-max at a window boundary
    (``step % window_size == 0``), else the running max (ref:
    ``quant/ops.py:94``)."""
    cur = abs_max_scale(x)
    prev = torch.as_tensor(prev_scale, dtype=cur.dtype, device=cur.device)
    at_boundary = torch.as_tensor(step) % window_size == 0
    return torch.where(at_boundary.to(cur.device), cur,
                       torch.maximum(prev, cur))


def quantize_to_int(x, scale, bits=8, channel_axis=None):
    """Real quantization: ``clip(round(x * (bound / s)), -bound, bound)``
    as int8 (``bits <= 8``) or int32 (ref: ``quant/ops.py:107``)."""
    bound = qrange(bits)
    s = _broadcast_scale(torch.clamp(torch.as_tensor(scale), min=1e-8), x,
                         channel_axis)
    # a true division: torch's ``bound / s`` is ``s.reciprocal() * bound``,
    # which rounds differently
    q = torch.clamp(torch.round(x * torch.div(torch.full_like(s, bound), s)),
                    -bound, bound)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def dequantize_from_int(q, scale, bits=8, channel_axis=None):
    """The inverse of :func:`quantize_to_int`, in f32 (ref:
    ``quant/ops.py:121``)."""
    bound = qrange(bits)
    q = torch.as_tensor(q).to(torch.float32)
    s = _broadcast_scale(torch.as_tensor(scale), q, channel_axis)
    return q * (s / bound)
