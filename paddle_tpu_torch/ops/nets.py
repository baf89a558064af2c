"""Composite network helpers (ref: ``paddle_tpu/ops/nets.py``): ``glu``,
``simple_img_conv_pool``, ``img_conv_group`` and ``sequence_conv_pool``
over the port's ``conv2d``, ``pool2d`` and sequence ops, with explicit
weights.
"""

import torch

from paddle_tpu_torch.core.ragged import RaggedBatch
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops import nn as F
from paddle_tpu_torch.ops import sequence as S


@register_op("glu")
def glu(x, axis=-1):
    """Gated linear unit: ``x`` split in half along ``axis``, ``a *
    sigmoid(b)``."""
    a, b = torch.chunk(x, 2, dim=axis)
    return a * activations.sigmoid(b)


def _ksize(w, data_format):
    # NCHW weights are OIHW, NHWC weights are HWIO
    return ((w.shape[2], w.shape[3]) if data_format == "NCHW"
            else (w.shape[0], w.shape[1]))


def _same_conv(x, w, b, data_format):
    kh, kw = _ksize(w, data_format)
    return F.conv2d(x, w, b, padding=((kh - 1) // 2, (kw - 1) // 2),
                    data_format=data_format)


@register_op("simple_img_conv_pool")
def simple_img_conv_pool(x, conv_w, conv_b=None, pool_size=2, pool_stride=2,
                         pool_type="max", act=None, data_format="NCHW"):
    """conv2d -> act -> pool2d (ref: ``nets.py:34``)."""
    out = _same_conv(x, conv_w, conv_b, data_format)
    if act is not None:
        out = getattr(activations, act)(out)
    return F.pool2d(out, pool_size, pool_type, pool_stride,
                    data_format=data_format)


@register_op("img_conv_group")
def img_conv_group(x, conv_weights, conv_biases=None, act="relu",
                   pool_size=2, pool_stride=2, pool_type="max",
                   data_format="NCHW"):
    """Stacked conv + act, then one pool (ref: ``nets.py:49``, the VGG
    block)."""
    act_fn = getattr(activations, act)
    biases = conv_biases or [None] * len(conv_weights)
    for w, b in zip(conv_weights, biases):
        x = act_fn(_same_conv(x, w, b, data_format))
    return F.pool2d(x, pool_size, pool_type, pool_stride,
                    data_format=data_format)


@register_op("sequence_conv_pool")
def sequence_conv_pool(rb, filter_w, act="tanh", pool_type="max"):
    """sequence_conv -> act -> sequence_pool (ref: ``nets.py:65``)."""
    out = S.sequence_conv(rb, filter_w)
    vals = getattr(activations, act)(out.values)
    return S.sequence_pool(RaggedBatch(vals, rb.row_lengths), pool_type)
