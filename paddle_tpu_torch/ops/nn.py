"""Neural-network ops (the port's subset of ``paddle_tpu/ops/nn.py``)."""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.cuda.layer_norm import layer_norm_fused


def matmul(a, b):
    """``a @ b`` with the reference's type promotion: operands of two
    floating types are both cast to ``torch.result_type(a, b)`` first, as
    jnp promotes them (an f32 activation times a bf16 weight is an f32
    product; torch's ``@`` refuses the mix). Operands of one type go to
    ``@`` as they are."""
    if a.dtype != b.dtype:
        dtype = torch.result_type(a, b)
        a, b = a.to(dtype), b.to(dtype)
    return a @ b


def layer_norm(x, scale=None, bias=None, begin_norm_axis=1, epsilon=1e-5):
    """Normalize over dims ``[begin_norm_axis:]``; scale/bias are flat over
    those dims (ref: ``paddle_tpu/ops/nn.py:361``). The K1 kernel on a
    CUDA tensor, its plain version on a CPU tensor; f32 statistics."""
    return layer_norm_fused(x, scale, bias, begin_norm_axis=begin_norm_axis,
                            epsilon=epsilon)


def lookup_table(ids, table, padding_idx=None):
    """Embedding lookup (ref: ``paddle_tpu/ops/nn.py:448``), including
    the reference's trailing-1 squeeze of the ids; rows of ids equal to
    ``padding_idx`` are zeros (the reference's mask, so they take no
    gradient)."""
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = table[ids.long()]
    if padding_idx is not None:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


# ---------------------------------------------------------------- conv
def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _explicit_pad(pad, x_sp, k_sp, stride, dilation):
    """``'SAME'``/``'VALID'``/``[(lo, hi), ...]`` as explicit per-dim
    ``(lo, hi)`` (ref: ``ops/nn.py:59``): SAME puts the odd pixel of an
    uneven total on the high side."""
    if isinstance(pad, str):
        if pad == "VALID":
            return [(0, 0)] * len(x_sp)
        out = []
        for x, k, s, d in zip(x_sp, k_sp, stride, dilation):
            k_eff = (k - 1) * d + 1
            total = max((-(-x // s) - 1) * s + k_eff - x, 0)
            out.append((total // 2, total - total // 2))
        return out
    return [tuple(p) for p in pad]


def _conv_pad(padding):
    """The reference's padding argument (an int, a pair, per-side
    ``((lo, hi), (lo, hi))``, ``'SAME'`` or ``'VALID'``) as ``'SAME'``,
    ``'VALID'`` or ``[(lo, hi), (lo, hi)]`` (ref: ``ops/nn.py:148-155``)."""
    if isinstance(padding, str):
        return padding.upper()
    p = _pair(padding)
    if isinstance(p[0], (tuple, list)):
        return [tuple(p[0]), tuple(p[1])]
    return [(p[0], p[0]), (p[1], p[1])]


def _padded(x, pads):
    """``x`` (NCHW view) and the symmetric padding F's op takes: the pads
    themselves when each dim's are equal, else ``x`` zero-padded
    explicitly (``F.pad``) and zero."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    (hl, hh), (wl, wh) = pads
    return F.pad(x, (wl, wh, hl, hh)), (0, 0)


def _nchw(x, data_format):
    """A logically NCHW view of ``x``: an NHWC tensor becomes its
    ``channels_last`` NCHW view, no copy."""
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(y, data_format):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution (ref: ``ops/nn.py:140``). ``weight`` is OIHW for
    NCHW and HWIO for NHWC, as the reference stores it. An NHWC input runs
    as torch's ``channels_last`` NCHW view, with the HWIO weight copied to
    a ``channels_last`` OIHW tensor for the library convolution (cuDNN on
    the card): the reference computes its convolutions outside any Pallas
    kernel, with XLA's. Padding takes every form the reference does; an
    uneven one (SAME at stride 2, per-side) is applied with ``F.pad``
    first. The bias is added after the product, as the reference adds it."""
    stride, dilation = _pair(stride), _pair(dilation)
    pad = _conv_pad(padding)
    xc = _nchw(x, data_format)
    if data_format == "NHWC":
        w = weight.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
    else:
        w = weight
    pads = _explicit_pad(pad, xc.shape[2:], w.shape[2:], stride, dilation)
    xc, sym = _padded(xc, pads)
    out = _from_nchw(F.conv2d(xc, w, None, stride, sym, dilation, groups),
                     data_format)
    if bias is not None:
        bshape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
        out = out + bias.reshape(bshape)
    return out


def depthwise_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                     data_format="NCHW"):
    """ref: ``ops/nn.py:178`` — :func:`conv2d` with one group a channel."""
    c = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    return conv2d(x, weight, bias, stride, padding, dilation, groups=c,
                  data_format=data_format)


# ---------------------------------------------------------------- pooling
def pool2d(x, pool_size=2, pool_type="max", stride=None, padding=0,
           global_pooling=False, exclusive=True, data_format="NCHW"):
    """ref: ``ops/nn.py:268``. Max pooling pads with ``-inf``; average
    pooling with ``exclusive`` divides by the window's unpadded count
    wherever padding can reach (integer pads or SAME), else by the window
    size. ``global_pooling`` reduces the spatial axes, keeping them."""
    if global_pooling:
        axes = (2, 3) if data_format == "NCHW" else (1, 2)
        if pool_type == "max":
            return torch.amax(x, dim=axes, keepdim=True)
        return torch.mean(x, dim=axes, keepdim=True)
    size = _pair(pool_size)
    stride = _pair(stride if stride is not None else pool_size)
    pad = _conv_pad(padding)
    xc = _nchw(x, data_format)
    pads = _explicit_pad(pad, xc.shape[2:], size, stride, (1, 1))
    (hl, hh), (wl, wh) = pads
    if pool_type == "max":
        if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, size)):
            xp, sym = xc, (hl, wl)
        else:
            xp, sym = F.pad(xc, (wl, wh, hl, hh), value=-math.inf), (0, 0)
        out = F.max_pool2d(xp, size, stride, sym)
    else:
        xp = F.pad(xc, (wl, wh, hl, hh)) if hl or hh or wl or wh else xc
        sums = F.avg_pool2d(xp, size, stride, divisor_override=1)
        if exclusive and pad != "VALID":
            ones = F.pad(torch.ones_like(xc[:1, :1]), (wl, wh, hl, hh))
            counts = F.avg_pool2d(ones, size, stride, divisor_override=1)
            out = sums / torch.clamp(counts, min=1.0)
        else:
            out = sums / (size[0] * size[1])
    return _from_nchw(out, data_format)


def adaptive_pool2d(x, output_size, pool_type="avg", data_format="NCHW"):
    """ref: ``ops/nn.py:306`` — the input's spatial sizes must be
    multiples of the output's (the reference's static-shape rule)."""
    oh, ow = _pair(output_size)
    h, w = x.shape[2:] if data_format == "NCHW" else x.shape[1:3]
    enforce(h % oh == 0 and w % ow == 0,
            "adaptive_pool2d requires divisible sizes (static shapes)")
    if data_format == "NCHW":
        n, c = x.shape[:2]
        x5 = x.reshape(n, c, oh, h // oh, ow, w // ow)
        red = (3, 5)
    else:
        n, c = x.shape[0], x.shape[3]
        x5 = x.reshape(n, oh, h // oh, ow, w // ow, c)
        red = (2, 4)
    if pool_type == "max":
        return torch.amax(x5, dim=red)
    return torch.mean(x5, dim=red)


# ---------------------------------------------------------------- norms
def batch_norm(x, scale, bias, mean, variance, epsilon=1e-5, momentum=0.9,
               training=False, data_format="NCHW"):
    """Batch norm as the reference writes it (ref: ``ops/nn.py:326``);
    returns ``(out, new_mean, new_variance)``, the inputs' statistics in
    eval mode. In training: one-pass f32 statistics ``E[x^2] - E[x]^2``
    clamped at 0, the running variance unbiased (``n / (n - 1)``), the
    running update in the statistics' own dtype (bf16 under the amp
    policy, constants rounded to it as jnp rounds a Python scalar), and
    the normalization in x's dtype: ``(x - m) * (rsqrt(v + eps) * scale) +
    bias``. ``F.batch_norm`` computes two-pass statistics and normalizes
    in f32, which is another function."""
    axis = 1 if data_format == "NCHW" else x.ndim - 1
    red = tuple(i for i in range(x.ndim) if i != axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    if training:
        xf = x.to(torch.float32)
        m = torch.mean(xf, dim=red)
        v = torch.clamp(torch.mean(torch.square(xf), dim=red)
                        - torch.square(m), min=0.0)
        n = x.numel() // x.shape[axis]
        unbiased = v * n / max(n - 1, 1)
        one = torch.ones((), dtype=mean.dtype, device=mean.device)
        mom = torch.full((), momentum, dtype=mean.dtype, device=mean.device)
        new_mean = mom * mean + (one - mom) * m.to(mean.dtype)
        new_var = mom * variance + (one - mom) * unbiased.to(variance.dtype)
        m, v = m.to(x.dtype), v.to(x.dtype)
    else:
        m, v = mean, variance
        new_mean, new_var = mean, variance
    veps = v.to(x.dtype) + torch.full((), epsilon, dtype=x.dtype,
                                      device=x.device)
    # rsqrt in f32, rounded once to x's dtype: torch's bf16 rsqrt on the
    # CPU is off by an ulp at times (rsqrt(4.84375) -> 0.453125, not the
    # nearest 0.455078 that the reference gives)
    inv = torch.rsqrt(veps.to(torch.float32)).to(x.dtype)
    out = (x - m.reshape(shape)) * (inv * scale).reshape(shape) \
        + bias.reshape(shape)
    return out, new_mean, new_var
