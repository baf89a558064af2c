"""Parameter initializers (ref: ``paddle_tpu/initializer.py``): every one
of the reference's.

Each initializer is ``fn(shape, gen, dtype) -> tensor``: it draws on the
CPU from the explicit ``torch.Generator`` ``gen`` (the reference's
explicit PRNG key), never from torch's global generator. The draws are
torch's, so they differ from the reference's; weights that must agree with
it come through ``paddle_tpu_torch/bridge.py``.
"""

import math

import numpy as np
import torch
from torch import nn


def _fans(shape):
    """(fan_in, fan_out) as the reference computes them (ref:
    ``initializer.py:18``): a conv kernel is read as OIHW."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def constant(value=0.0):
    """Every entry ``value`` (ref: ``initializer.py:32``); draws nothing
    from ``gen``."""
    def init(shape, gen=None, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype)
    return init


def zeros():
    """ref: ``initializer.py:38``."""
    return constant(0.0)


def ones():
    """ref: ``initializer.py:42``."""
    return constant(1.0)


def normal(loc=0.0, scale=1.0):
    """N(loc, scale^2) (ref: ``initializer.py:52``)."""
    def init(shape, gen=None, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype).normal_(loc, scale,
                                                       generator=gen)
    return init


def uniform(low=-1.0, high=1.0):
    """U(low, high) (ref: ``initializer.py:46``)."""
    def init(shape, gen=None, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype).uniform_(low, high,
                                                        generator=gen)
    return init


def truncated_normal(loc=0.0, scale=1.0):
    """``loc + scale * z``, z a standard normal truncated to [-2, 2] (ref:
    ``initializer.py:58``)."""
    def init(shape, gen=None, dtype=torch.float32):
        z = torch.nn.init.trunc_normal_(torch.empty(shape, dtype=dtype),
                                        0.0, 1.0, -2.0, 2.0, generator=gen)
        return loc + scale * z
    return init


def xavier(fan_in=None, fan_out=None):
    """Glorot uniform, ``limit = sqrt(6 / (fan_in + fan_out))`` (ref:
    ``initializer.py:65``); ``fan_in`` / ``fan_out`` override the fans of
    the shape (the MoE's per-expert ``[E, D, H]`` kernels)."""
    def init(shape, gen=None, dtype=torch.float32):
        w = torch.empty(shape, dtype=dtype)
        if fan_in is None and fan_out is None:
            nn.init.xavier_uniform_(w, generator=gen)
            return w
        fi, fo = _fans(shape)
        fi = fan_in if fan_in is not None else fi
        fo = fan_out if fan_out is not None else fo
        limit = math.sqrt(6.0 / (fi + fo))
        return w.uniform_(-limit, limit, generator=gen)
    return init


def msra(uniform_=False, fan_in=None):
    """Kaiming/He (ref: ``initializer.py:80``): N(0, 2 / fan_in), or
    U(-sqrt(6 / fan_in), sqrt(6 / fan_in)) with ``uniform_``; the fan of a
    conv kernel on its OIHW view."""
    def init(shape, gen=None, dtype=torch.float32):
        fi = fan_in if fan_in is not None else _fans(shape)[0]
        w = torch.empty(shape, dtype=dtype)
        if uniform_:
            limit = math.sqrt(6.0 / fi)
            return w.uniform_(-limit, limit, generator=gen)
        return w.normal_(0.0, math.sqrt(2.0 / fi), generator=gen)
    return init


def bilinear():
    """The bilinear upsampling kernel of a transposed convolution, on the
    diagonal channels of ``[C, C', kh, kw]`` (ref: ``initializer.py:94``);
    draws nothing from ``gen``."""
    def init(shape, gen=None, dtype=torch.float32):
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        og = np.ogrid[:kh, :kw]
        filt = ((1 - abs(og[0] / f_h - c_h)) * (1 - abs(og[1] / f_w - c_w)))
        w = np.zeros(shape, np.float32)
        for i in range(min(shape[0], shape[1])):
            w[i, i] = filt
        return torch.from_numpy(w).to(dtype)
    return init


def numpy_array(arr):
    """The given array, which must have the parameter's shape (ref:
    ``initializer.py:112``); draws nothing from ``gen``."""
    def init(shape, gen=None, dtype=torch.float32):
        a = torch.as_tensor(np.asarray(arr)).to(dtype).clone()
        assert tuple(a.shape) == tuple(shape), (tuple(a.shape), shape)
        return a
    return init
