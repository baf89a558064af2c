"""Dense math ops (ref: ``paddle_tpu/ops/math.py``): matmul and mul, the
``elementwise_*`` family with the reference's ``axis`` broadcast, the
unary math names, reductions, cumulative sums and norms.

The reference sets its matmul precision from a flag; the port's f32
products are f32 (``chip_smoke.py`` turns TF32 off on the card).
Reductions take ``dim`` as None (every axis), an int or a list, and
``keep_dim`` as the reference does.
"""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.nn import matmul as _promoting_matmul


@register_op("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0):
    """Batched matmul (ref: ``ops/math.py:25``); operands of two float
    types promote as jnp promotes them."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = _promoting_matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return out


@register_op("mul")
def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """The reference's ``mul`` op: x flattened to 2-D at x_num_col_dims, y
    at y_num_col_dims, then a matmul (ref: ``ops/math.py:38``)."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(_numel(xs[:x_num_col_dims]), -1)
    y2 = y.reshape(_numel(ys[:y_num_col_dims]), -1)
    return _promoting_matmul(x2, y2).reshape(xs[:x_num_col_dims]
                                             + ys[y_num_col_dims:])


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


@register_op("bmm")
def bmm(x, y):
    return _promoting_matmul(x, y)


@register_op("dot")
def dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


# --- elementwise binary: y's dims align with x's starting at ``axis`` ---

def _ew_broadcast(x, y, axis):
    """ref: ``ops/math.py:63``."""
    if axis == -1 or y.ndim == x.ndim:
        return x, y
    pad = x.ndim - axis - y.ndim
    return x, y.reshape(tuple(y.shape) + (1,) * pad)


@register_op("elementwise_add")
def elementwise_add(x, y, axis=-1):
    x, y = _ew_broadcast(x, y, axis)
    return x + y


@register_op("elementwise_sub")
def elementwise_sub(x, y, axis=-1):
    x, y = _ew_broadcast(x, y, axis)
    return x - y


@register_op("elementwise_mul")
def elementwise_mul(x, y, axis=-1):
    x, y = _ew_broadcast(x, y, axis)
    return x * y


@register_op("elementwise_div")
def elementwise_div(x, y, axis=-1):
    x, y = _ew_broadcast(x, y, axis)
    return x / y


@register_op("elementwise_max")
def elementwise_max(x, y, axis=-1):
    x, y = _ew_broadcast(x, y, axis)
    return torch.maximum(x, y)


@register_op("elementwise_min")
def elementwise_min(x, y, axis=-1):
    x, y = _ew_broadcast(x, y, axis)
    return torch.minimum(x, y)


@register_op("elementwise_pow")
def elementwise_pow(x, y, axis=-1):
    x, y = _ew_broadcast(x, y, axis)
    return torch.pow(x, y)


@register_op("elementwise_mod")
def elementwise_mod(x, y, axis=-1):
    """The divisor's sign, as ``jnp.mod``."""
    x, y = _ew_broadcast(x, y, axis)
    return torch.remainder(x, y)


@register_op("elementwise_floordiv")
def elementwise_floordiv(x, y, axis=-1):
    x, y = _ew_broadcast(x, y, axis)
    return torch.floor_divide(x, y)


# --- unary math (ref: ``ops/math.py:125-135``) ---
for _name, _fn in [
    ("exp", torch.exp), ("log", torch.log), ("log2", torch.log2),
    ("log10", torch.log10), ("log1p", torch.log1p), ("sqrt", torch.sqrt),
    ("rsqrt", torch.rsqrt), ("abs", torch.abs), ("ceil", torch.ceil),
    ("floor", torch.floor), ("round", torch.round), ("sign", torch.sign),
    ("square", torch.square), ("reciprocal", torch.reciprocal),
    ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
    ("asin", torch.asin), ("acos", torch.acos), ("atan", torch.atan),
    ("sinh", torch.sinh), ("cosh", torch.cosh), ("erf", torch.erf),
]:
    globals()[_name] = register_op(_name)(_fn)
del _name, _fn


@register_op("pow")
def pow(x, factor=1.0):
    return torch.pow(x, factor)


@register_op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    """ref: ``ops/math.py:143``."""
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@register_op("clip")
def clip(x, min, max):
    """``jnp.clip``: maximum, then minimum (its gradient at a bound)."""
    lo = torch.as_tensor(min, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(max, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


@register_op("clip_by_norm")
def clip_by_norm(x, max_norm):
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm,
                       x * (max_norm / torch.clamp_min(norm, 1e-12)), x)


# --- reductions (ref: ``ops/math.py:160-196``) ---

def _dims(x, dim):
    if dim is None:
        return tuple(range(x.ndim))
    if isinstance(dim, int):
        return (dim,)
    return tuple(dim)


def _reduce(fn, x, dim, keep_dim):
    """``fn(x, d, keepdim=True)`` over each axis of ``dim`` (largest
    first), then the reduced axes dropped unless ``keep_dim``."""
    dims = sorted((d % x.ndim for d in _dims(x, dim)), reverse=True)
    out = x
    for d in dims:
        out = fn(out, d, keepdim=True)
    if not keep_dim:
        for d in dims:
            out = out.squeeze(d)
    return out


@register_op("reduce_sum")
def reduce_sum(x, dim=None, keep_dim=False):
    return torch.sum(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("reduce_mean")
def reduce_mean(x, dim=None, keep_dim=False):
    return torch.mean(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("reduce_max")
def reduce_max(x, dim=None, keep_dim=False):
    return torch.amax(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("reduce_min")
def reduce_min(x, dim=None, keep_dim=False):
    return torch.amin(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("reduce_prod")
def reduce_prod(x, dim=None, keep_dim=False):
    return _reduce(torch.prod, x, dim, keep_dim)


@register_op("reduce_all")
def reduce_all(x, dim=None, keep_dim=False):
    return _reduce(torch.all, x.bool(), dim, keep_dim)


@register_op("reduce_any")
def reduce_any(x, dim=None, keep_dim=False):
    return _reduce(torch.any, x.bool(), dim, keep_dim)


@register_op("logsumexp")
def logsumexp(x, dim=None, keep_dim=False):
    return torch.logsumexp(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("mean")
def mean(x):
    return torch.mean(x)


@register_op("sum")
def sum(xs):
    """Sum of a list of tensors, or of a tensor's entries (ref:
    ``ops/math.py:201``)."""
    if isinstance(xs, (list, tuple)):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
    return torch.sum(xs)


@register_op("cumsum")
def cumsum(x, axis=None, exclusive=False, reverse=False):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, axis)
    if exclusive:
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    return out


@register_op("cumprod")
def cumprod(x, axis=0):
    return torch.cumprod(x, axis)


@register_op("norm")
def norm(x, p=2, axis=-1, epsilon=1e-10):
    """x over its p-norm along ``axis`` (ref: ``ops/math.py:232``)."""
    if p == 2:
        n = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                       + epsilon)
    else:
        n = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                                keepdim=True) + epsilon, 1.0 / p)
    return x / n


@register_op("frobenius_norm")
def frobenius_norm(x, dim=None, keep_dim=False):
    return torch.sqrt(torch.sum(torch.square(x), dim=_dims(x, dim),
                                keepdim=keep_dim))


@register_op("kron")
def kron(x, y):
    return torch.kron(x, y)


@register_op("addmm")
def addmm(input, x, y, alpha=1.0, beta=1.0):
    return beta * input + alpha * _promoting_matmul(x, y)


@register_op("isfinite")
def isfinite(x):
    """One bool: every entry finite."""
    return torch.all(torch.isfinite(x))


@register_op("isnan")
def isnan(x):
    return torch.isnan(x)


@register_op("isinf")
def isinf(x):
    return torch.isinf(x)


@register_op("increment")
def increment(x, value=1.0):
    return x + value


@register_op("maximum")
def maximum(x, y):
    return torch.maximum(x, y)


@register_op("minimum")
def minimum(x, y):
    return torch.minimum(x, y)
