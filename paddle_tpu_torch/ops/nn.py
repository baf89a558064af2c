"""Neural-network ops (ref: ``paddle_tpu/ops/nn.py``), registered under
the reference's names, and the promoting ``matmul`` the port's models use."""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op
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


@register_op("layer_norm")
def layer_norm(x, scale=None, bias=None, begin_norm_axis=1, epsilon=1e-5):
    """Normalize over dims ``[begin_norm_axis:]``; scale/bias are flat over
    those dims (ref: ``paddle_tpu/ops/nn.py:361``). The K1 kernel on a
    CUDA tensor, its plain version on a CPU tensor; f32 statistics."""
    return layer_norm_fused(x, scale, bias, begin_norm_axis=begin_norm_axis,
                            epsilon=epsilon)


@register_op("lookup_table")
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


@register_op("conv2d")
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


@register_op("depthwise_conv2d")
def depthwise_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                     data_format="NCHW"):
    """ref: ``ops/nn.py:178`` — :func:`conv2d` with one group a channel."""
    c = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    return conv2d(x, weight, bias, stride, padding, dilation, groups=c,
                  data_format=data_format)


# ---------------------------------------------------------------- pooling
@register_op("pool2d")
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


@register_op("adaptive_pool2d")
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
@register_op("batch_norm")
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


# ------------------------------------------------- the rest of the surface
@register_op("fc")
def fc(x, weight, bias=None, num_flatten_dims=1, act=None):
    """x ``[..., in]`` flattened to 2-D at ``num_flatten_dims``, times
    weight ``[in, out]``, plus bias, then the activation named ``act``
    (ref: ``ops/nn.py:32``)."""
    from paddle_tpu_torch.ops import activations
    lead_shape = tuple(x.shape[:num_flatten_dims])
    tail = 1
    for d in x.shape[num_flatten_dims:]:
        tail *= int(d)
    out = matmul(x.reshape(-1, tail), weight)
    if bias is not None:
        out = out + bias
    if act is not None:
        out = getattr(activations, act)(out)
    return out.reshape(lead_shape + (weight.shape[-1],))


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


@register_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """NCDHW with an OIDHW weight (ref: ``ops/nn.py:187``); padding an
    int, a triple, ``'SAME'`` or ``'VALID'``."""
    s, d = _triple(stride), _triple(dilation)
    if isinstance(padding, str):
        pads = _explicit_pad(padding.upper(), x.shape[2:], weight.shape[2:],
                             s, d)
    else:
        pads = [(p, p) for p in _triple(padding)]
    if all(lo == hi for lo, hi in pads):
        out = F.conv3d(x, weight, None, s, tuple(lo for lo, _ in pads), d,
                       groups)
    else:
        flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
        out = F.conv3d(F.pad(x, flat), weight, None, s, 0, d, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out


def _lhs_dilate(x, stride):
    """NCHW x with ``stride - 1`` zeros between neighbours (the
    ``lhs_dilation`` of ``lax.conv_general_dilated``)."""
    if stride == (1, 1):
        return x
    n, c, h, w = x.shape
    out = x.new_zeros(n, c, (h - 1) * stride[0] + 1, (w - 1) * stride[1] + 1)
    out[:, :, ::stride[0], ::stride[1]] = x
    return out


@register_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    """Transposed convolution, written as the reference writes it (ref:
    ``ops/nn.py:208``): an input-dilated convolution with the flipped,
    in/out-swapped weight ``[in_c, out_c/groups, kh, kw]``."""
    stride, dilation = _pair(stride), _pair(dilation)
    p = _pair(padding) if not isinstance(padding, str) else padding
    op = _pair(output_padding)
    kh, kw = weight.shape[2], weight.shape[3]
    w = torch.flip(weight, (2, 3)).transpose(0, 1)
    if groups > 1:
        in_c, ocg = weight.shape[0], weight.shape[1]
        wg = weight.reshape(groups, in_c // groups, ocg, kh, kw)
        wg = torch.flip(wg, (3, 4)).transpose(1, 2)
        w = wg.reshape(groups * ocg, in_c // groups, kh, kw)
    if data_format != "NCHW":
        w = w.permute(3, 2, 0, 1)          # the reference reads it as HWIO
    xd = _lhs_dilate(_nchw(x, data_format), stride)
    if isinstance(p, str):
        pads = []
        for k, dl in zip(w.shape[2:], dilation):
            total = (max((k - 1) * dl, 0) if p.upper() == "SAME" else 0)
            pads.append((total // 2, total - total // 2))
    else:
        pads = [(dilation[0] * (kh - 1) - p[0],
                 dilation[0] * (kh - 1) - p[0] + op[0]),
                (dilation[1] * (kw - 1) - p[1],
                 dilation[1] * (kw - 1) - p[1] + op[1])]
    (hl, hh), (wl, wh) = pads
    out = F.conv2d(F.pad(xd, (wl, wh, hl, hh)), w, None, 1, 0, dilation,
                   groups)
    out = _from_nchw(out, data_format)
    if bias is not None:
        bshape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
        out = out + bias.reshape(bshape)
    return out


@register_op("rms_norm")
def rms_norm(x, scale=None, epsilon=1e-6, axis=-1):
    """RMSNorm (ref: ``ops/nn.py:371``): f32 statistics."""
    v = torch.mean(torch.square(x.to(torch.float32)), dim=axis, keepdim=True)
    out = x * torch.rsqrt(v + epsilon).to(x.dtype)
    if scale is not None:
        out = out * scale
    return out


@register_op("group_norm")
def group_norm(x, scale=None, bias=None, groups=32, epsilon=1e-5,
               data_format="NCHW"):
    """ref: ``ops/nn.py:381`` (NCHW only)."""
    enforce(data_format == "NCHW", "group_norm supports NCHW")
    n, c, h, w = x.shape
    xg = x.reshape(n, groups, c // groups, h, w)
    m = torch.mean(xg, dim=(2, 3, 4), keepdim=True)
    v = torch.var(xg, dim=(2, 3, 4), keepdim=True, unbiased=False)
    out = ((xg - m) * torch.rsqrt(v + epsilon)).reshape(n, c, h, w)
    if scale is not None:
        out = out * scale.reshape(1, c, 1, 1)
    if bias is not None:
        out = out + bias.reshape(1, c, 1, 1)
    return out


@register_op("instance_norm")
def instance_norm(x, scale=None, bias=None, epsilon=1e-5):
    red = tuple(range(2, x.ndim))
    m = torch.mean(x, dim=red, keepdim=True)
    v = torch.var(x, dim=red, keepdim=True, unbiased=False)
    out = (x - m) * torch.rsqrt(v + epsilon)
    shp = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    if scale is not None:
        out = out * scale.reshape(shp)
    if bias is not None:
        out = out + bias.reshape(shp)
    return out


@register_op("l2_normalize")
def l2_normalize(x, axis=-1, epsilon=1e-12):
    return x * torch.rsqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                           + epsilon)


@register_op("lrn")
def lrn(x, n=5, k=1.0, alpha=1e-4, beta=0.75):
    """Local response norm over NCHW channels (ref: ``ops/nn.py:430``)."""
    half = n // 2
    padded = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = torch.zeros_like(x)
    for i in range(n):
        acc = acc + padded[:, i:i + x.shape[1]]
    return x / torch.pow(k + alpha * acc, beta)


@register_op("dropout")
def dropout(x, generator, rate=0.5, training=True, mode="upscale_in_train"):
    """The reference's two modes (ref: ``ops/nn.py:443``), the keep-mask
    drawn from the explicit ``generator`` where the reference takes a
    key: ``upscale_in_train`` scales kept values by ``1 / (1 - rate)``;
    ``downgrade_in_infer`` scales by ``1 - rate`` at inference."""
    if not training or rate == 0.0:
        if mode == "downgrade_in_infer" and not training:
            return x * (1.0 - rate)
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros_like(x)).to(x.dtype)


@register_op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """Nearest and bilinear resize with the reference's sample positions
    (ref: ``ops/nn.py:473``), computed in f32 as it computes them."""
    if data_format == "NCHW":
        h, w = x.shape[2], x.shape[3]
    else:
        h, w = x.shape[1], x.shape[2]
    if size is None:
        sf = _pair(scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    oh, ow = _pair(size)

    def ar(n):
        return torch.arange(n, dtype=torch.float32, device=x.device)
    if mode == "nearest":
        ri = (ar(oh) * (h / oh)).long()
        ci = (ar(ow) * (w / ow)).long()
        if data_format == "NCHW":
            return x[:, :, ri][:, :, :, ci]
        return x[:, ri][:, :, ci]
    if align_corners and oh > 1 and ow > 1:
        ys = torch.linspace(0.0, h - 1, oh, device=x.device)
        xs = torch.linspace(0.0, w - 1, ow, device=x.device)
    else:
        ys = torch.clamp((ar(oh) + 0.5) * (h / oh) - 0.5, 0, h - 1)
        xs = torch.clamp((ar(ow) + 0.5) * (w / ow) - 0.5, 0, w - 1)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0).to(x.dtype)[None, None, :, None]
    wx = (xs - x0).to(x.dtype)[None, None, None, :]
    xc = x if data_format == "NCHW" else x.movedim(-1, 1)
    a = xc[:, :, y0][:, :, :, x0]
    b = xc[:, :, y0][:, :, :, x1]
    c = xc[:, :, y1][:, :, :, x0]
    d = xc[:, :, y1][:, :, :, x1]
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
           + c * wy * (1 - wx) + d * wy * wx)
    return out if data_format == "NCHW" else out.movedim(1, -1)


@register_op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor):
    n, c, h, w = x.shape
    r = upscale_factor
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


@register_op("affine_channel")
def affine_channel(x, scale, bias, data_format="NCHW"):
    shp = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
    return x * scale.reshape(shp) + bias.reshape(shp)


@register_op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: ``[n, c * kh * kw, oh * ow]``, channel-major as the
    reference stacks its patches (ref: ``ops/nn.py:543``)."""
    kh, kw = _pair(kernel_sizes)
    s, d, p = _pair(strides), _pair(dilations), _pair(paddings)
    n, c, h, w = x.shape
    x = F.pad(x, (p[1], p[1], p[0], p[0]))
    oh = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    patches = [x[:, :, i * d[0]: i * d[0] + oh * s[0]: s[0],
                 j * d[1]: j * d[1] + ow * s[1]: s[1]]
               for i in range(kh) for j in range(kw)]
    return torch.stack(patches, dim=2).reshape(n, c * kh * kw, oh * ow)


@register_op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@register_op("fsp_matrix")
def fsp_matrix(x, y):
    """Per sample ``X_flat @ Y_flat^T / (H * W)``: x ``[B, C1, H, W]``,
    y ``[B, C2, H, W]`` -> ``[B, C1, C2]`` (ref: ``ops/nn.py:565``)."""
    enforce(x.shape[0] == y.shape[0] and x.shape[2:] == y.shape[2:],
            "fsp_matrix requires matching batch and spatial dims")
    return torch.einsum("bchw,bdhw->bcd", x, y) / (x.shape[2] * x.shape[3])
