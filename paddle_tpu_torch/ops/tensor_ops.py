"""Tensor manipulation, creation, comparison and random ops (ref:
``paddle_tpu/ops/tensor_ops.py``).

The reference's static-shape redesigns are kept: ``masked_select``
returns ``(values[size], count)`` and ``unique_with_counts`` returns
padded ``(unique[size], counts[size], num)``.

**dtypes.** Float outputs have the reference's dtype. Integer outputs
equal the reference's by value: torch's index type is int64, where the
reference, running without x64, gives int32 (``argmax``, ``top_k``'s
indices, ``arange``'s default, the counts).

**Placement.** An op with a tensor input runs where that input lies. The
creation ops (``fill_constant``, ``arange``, ``linspace``, ``eye``) take
``device=``; left None, it is the device of the innermost
:func:`placement` block (the Executor opens one for its place), else the
card. The random ops draw from an explicit ``torch.Generator`` where the
reference takes a key, on the generator's device.
"""

import contextlib
import threading

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.core.registry import register_op

_PLACE = threading.local()


@contextlib.contextmanager
def placement(device):
    """Creation ops called without ``device=`` inside this block make
    their tensors on ``device``."""
    prev = getattr(_PLACE, "device", None)
    _PLACE.device = resolve_device(device)
    try:
        yield _PLACE.device
    finally:
        _PLACE.device = prev


def creation_device(device=None):
    """``device``, else the current :func:`placement`, else the card."""
    if device is not None:
        return resolve_device(device)
    placed = getattr(_PLACE, "device", None)
    return placed if placed is not None else resolve_device("cuda")


@register_op("cast")
def cast(x, dtype):
    return x.to(convert_dtype(dtype))


@register_op("concat")
def concat(xs, axis=0):
    return torch.cat(list(xs), dim=axis)


@register_op("split")
def split(x, num_or_sections, axis=0):
    """Equal parts, or parts cut at the running sums of the sections (the
    last part takes the rest), as ``jnp.split`` at those indices."""
    if isinstance(num_or_sections, int):
        return list(torch.tensor_split(x, num_or_sections, dim=axis))
    cuts, total = [], 0
    for s in list(num_or_sections)[:-1]:
        total += int(s)
        cuts.append(total)
    return list(torch.tensor_split(x, cuts, dim=axis))


@register_op("stack")
def stack(xs, axis=0):
    return torch.stack(list(xs), dim=axis)


@register_op("unstack")
def unstack(x, axis=0):
    return list(torch.unbind(x, dim=axis))


@register_op("squeeze")
def squeeze(x, axes=None):
    if not axes:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=tuple(axes))


@register_op("unsqueeze")
def unsqueeze(x, axes):
    if isinstance(axes, int):
        axes = [axes]
    for a in sorted(axes):
        x = torch.unsqueeze(x, a)
    return x


@register_op("reshape")
def reshape(x, shape):
    return torch.reshape(x, tuple(shape))


@register_op("flatten")
def flatten(x, axis=1):
    """To 2-D at ``axis`` (ref: ``ops/tensor_ops.py:67``)."""
    lead = 1
    for d in x.shape[:axis]:
        lead *= int(d)
    return x.reshape(lead, -1)


@register_op("transpose")
def transpose(x, perm):
    return x.permute(*perm)


def _axis_slice(x, axis, start, end, step=1):
    """``x[..., start:end:step, ...]`` on ``axis``; a negative step takes
    the indices Python's slice gives."""
    if step > 0:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, end, step)
        return x[tuple(idx)]
    keep = list(range(*slice(start, end, step).indices(x.shape[axis])))
    return x.index_select(axis, torch.tensor(keep, dtype=torch.long,
                                             device=x.device))


@register_op("slice")
def slice_(x, axes, starts, ends):
    """ref: ``ops/tensor_ops.py:80``."""
    for a, s, e in zip(axes, starts, ends):
        x = _axis_slice(x, a, s, e)
    return x


@register_op("strided_slice")
def strided_slice(x, axes, starts, ends, strides):
    for a, s, e, st in zip(axes, starts, ends, strides):
        x = _axis_slice(x, a, s, e, st)
    return x


def _take(x, index, axis):
    """``jnp.take(x, index, axis)`` for in-range (or negative) indices."""
    axis = axis % x.ndim
    n = x.shape[axis]
    idx = index.long()
    idx = torch.where(idx < 0, idx + n, idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                       + tuple(x.shape[axis + 1:]))


@register_op("gather")
def gather(x, index, axis=0):
    """ref: ``ops/tensor_ops.py:95``."""
    return _take(x, index, axis)


def _nd_index(index):
    return tuple(index.long().movedim(-1, 0))


@register_op("gather_nd")
def gather_nd(x, index):
    """index ``[..., k]`` selects over x's leading k dims."""
    return x[_nd_index(index)]


@register_op("scatter")
def scatter(x, index, updates, overwrite=True):
    """Rows of x at ``index`` set to (or, without ``overwrite``, added to)
    ``updates``; out of place."""
    return x.index_put((index.long(),), updates.to(x.dtype),
                       accumulate=not overwrite)


@register_op("scatter_nd_add")
def scatter_nd_add(x, index, updates):
    return x.index_put(_nd_index(index), updates.to(x.dtype),
                       accumulate=True)


@register_op("expand")
def expand(x, expand_times):
    """Tile semantics (ref: ``ops/tensor_ops.py:126``)."""
    return torch.tile(x, tuple(expand_times))


@register_op("expand_as")
def expand_as(x, target):
    return torch.tile(x, tuple(t // s for t, s in zip(target.shape,
                                                      x.shape)))


@register_op("broadcast_to")
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(shape))


@register_op("tile")
def tile(x, reps):
    return torch.tile(x, tuple(reps))


@register_op("reverse")
def reverse(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, tuple(axis))


@register_op("roll")
def roll(x, shifts, axis=None):
    return torch.roll(x, shifts, axis)


@register_op("top_k")
def top_k(x, k):
    """The ``k`` largest entries of each row of x and their indices, the
    lower index first among equal values, as ``lax.top_k`` orders them
    (``torch.topk`` does not promise an order for ties). A stable sort
    keeps equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("argsort")
def argsort(x, axis=-1, descending=False):
    """``(sorted, indices)``; a stable sort of ``-x`` when descending, as
    the reference sorts."""
    idx = torch.argsort(-x if descending else x, dim=axis, stable=True)
    return torch.take_along_dim(x, idx, dim=axis), idx


@register_op("sort")
def sort(x, axis=-1, descending=False):
    s = torch.sort(x, dim=axis).values
    return torch.flip(s, (axis,)) if descending else s


@register_op("argmax")
def argmax(x, axis=-1):
    return torch.argmax(x, dim=axis)


@register_op("argmin")
def argmin(x, axis=-1):
    return torch.argmin(x, dim=axis)


@register_op("one_hot")
def one_hot(x, depth, dtype=torch.float32):
    """An id outside ``[0, depth)`` gives a row of zeros, as
    ``jax.nn.one_hot``."""
    if x.ndim > 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    classes = torch.arange(depth, device=x.device)
    return (x.long()[..., None] == classes).to(convert_dtype(dtype))


@register_op("where")
def where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    return torch.where(condition, x, y)


@register_op("masked_select")
def masked_select(x, mask, size=None):
    """Static-shape masked select: ``(values[size], count)``, the selected
    values first in order, then zeros (ref: ``ops/tensor_ops.py:210``)."""
    flat_x = x.reshape(-1)
    flat_m = mask.reshape(-1).bool()
    size = size if size is not None else flat_x.shape[0]
    order = torch.argsort((~flat_m).to(torch.uint8), stable=True)
    vals = torch.where(flat_m[order], flat_x[order],
                       torch.zeros_like(flat_x))[:size]
    return vals, flat_m.sum()


@register_op("unique_with_counts")
def unique_with_counts(x, size=None):
    """Static-shape unique (ref: ``ops/tensor_ops.py:222``): ``(unique
    [size], counts[size], num_unique)``, ascending, padded with zeros."""
    flat = x.reshape(-1)
    size = size if size is not None else flat.shape[0]
    u, cnt = torch.unique(flat, sorted=True, return_counts=True)
    u, cnt = u[:size], cnt[:size]
    pad = size - u.shape[0]
    u = F.pad(u, (0, pad))
    cnt = F.pad(cnt, (0, pad))
    return u, cnt, (cnt > 0).sum()


@register_op("shard_index")
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    """Global ids to per-shard local ids (ref: ``ops/tensor_ops.py:232``)."""
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.floor_divide(x, shard_size) == shard_id
    return torch.where(in_shard, torch.remainder(x, shard_size),
                       torch.full_like(x, ignore_value))


@register_op("index_select")
def index_select(x, index, axis=0):
    return _take(x, index, axis)


@register_op("index_sample")
def index_sample(x, index):
    """Per-row gather."""
    return torch.gather(x, 1, index.long())


# --- creation ops ---
@register_op("fill_constant")
def fill_constant(shape, dtype, value, device=None):
    return torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                      device=creation_device(device))


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(input, shape, dtype, value):
    shape = (input.shape[0],) + tuple(shape[1:])
    return torch.full(shape, value, dtype=convert_dtype(dtype),
                      device=input.device)


@register_op("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register_op("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register_op("arange")
def arange(start, end=None, step=1, dtype=torch.int64, device=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=creation_device(device))


@register_op("linspace")
def linspace(start, stop, num, dtype=torch.float32, device=None):
    return torch.linspace(start, stop, num, dtype=convert_dtype(dtype),
                          device=creation_device(device))


@register_op("eye")
def eye(num_rows, num_columns=None, dtype=torch.float32, device=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=convert_dtype(dtype),
                     device=creation_device(device))


@register_op("diag")
def diag(x):
    return torch.diag(x)


# --- random ops: an explicit generator where the reference takes a key ---
@register_op("uniform_random")
def uniform_random(generator, shape, dtype=torch.float32, min=-1.0,
                   max=1.0):
    """Uniform in ``[min, max)`` (ref: ``ops/tensor_ops.py:294``)."""
    u = torch.rand(tuple(shape), generator=generator,
                   device=generator.device, dtype=convert_dtype(dtype))
    return u * (max - min) + min


@register_op("gaussian_random")
def gaussian_random(generator, shape, dtype=torch.float32, mean=0.0,
                    std=1.0):
    return mean + std * torch.randn(tuple(shape), generator=generator,
                                    device=generator.device,
                                    dtype=convert_dtype(dtype))


@register_op("randint")
def randint(generator, low, high, shape, dtype=torch.int32):
    return torch.randint(low, high, tuple(shape), generator=generator,
                         device=generator.device,
                         dtype=convert_dtype(dtype))


@register_op("randperm")
def randperm(generator, n, dtype=torch.int32):
    return torch.randperm(n, generator=generator,
                          device=generator.device).to(convert_dtype(dtype))


@register_op("multinomial")
def multinomial(generator, probs, num_samples, replacement=True):
    """``num_samples`` class ids per row of ``probs`` (any leading
    dims), with or without replacement."""
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, num_samples, replacement=replacement,
                            generator=generator)
    return out.reshape(tuple(probs.shape[:-1]) + (num_samples,))


@register_op("shape")
def shape(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@register_op("size")
def size(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


# --- comparison / logical ---
@register_op("equal")
def equal(x, y):
    return torch.eq(x, y)


@register_op("not_equal")
def not_equal(x, y):
    return torch.ne(x, y)


@register_op("less_than")
def less_than(x, y):
    return torch.lt(x, y)


@register_op("less_equal")
def less_equal(x, y):
    return torch.le(x, y)


@register_op("greater_than")
def greater_than(x, y):
    return torch.gt(x, y)


@register_op("greater_equal")
def greater_equal(x, y):
    return torch.ge(x, y)


@register_op("logical_and")
def logical_and(x, y):
    return torch.logical_and(x, y)


@register_op("logical_or")
def logical_or(x, y):
    return torch.logical_or(x, y)


@register_op("logical_xor")
def logical_xor(x, y):
    return torch.logical_xor(x, y)


@register_op("logical_not")
def logical_not(x):
    return torch.logical_not(x)


@register_op("allclose")
def allclose(x, y, rtol=1e-5, atol=1e-8):
    """One bool tensor on x's device (``jnp.allclose``)."""
    return torch.all(torch.isclose(x, y, rtol=rtol, atol=atol))


def _pairs(paddings):
    if paddings and not isinstance(paddings[0], (tuple, list)):
        return [(paddings[2 * i], paddings[2 * i + 1])
                for i in range(len(paddings) // 2)]
    return [tuple(p) for p in paddings]


def _torch_pad(pairs):
    """Per-dim ``(lo, hi)`` pairs, first dim first, as ``F.pad``'s flat
    last-dim-first list."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


@register_op("pad")
def pad(x, paddings, pad_value=0.0):
    """paddings: ``[(lo, hi), ...]`` per dim, or flat ``[lo0, hi0, lo1,
    hi1, ...]`` (ref: ``ops/tensor_ops.py:365``)."""
    pairs = _pairs(paddings)
    pairs += [(0, 0)] * (x.ndim - len(pairs))
    return F.pad(x, _torch_pad(pairs), value=pad_value)


@register_op("pad2d")
def pad2d(x, paddings, mode="constant", pad_value=0.0, data_format="NCHW"):
    """Pad the H/W dims of an NCHW or NHWC input; modes constant, reflect
    and edge."""
    t, b, l, r = paddings
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    if mode == "constant":
        out = F.pad(x, (l, r, t, b), value=pad_value)
    else:
        out = F.pad(x, (l, r, t, b),
                    mode={"reflect": "reflect", "edge": "replicate"}[mode])
    return out if data_format == "NCHW" else out.permute(0, 2, 3, 1)


@register_op("meshgrid")
def meshgrid(*xs):
    return list(torch.meshgrid(*xs, indexing="ij"))


@register_op("take_along_axis")
def take_along_axis(x, idx, axis):
    return torch.take_along_dim(x, idx.long(), dim=axis)


@register_op("put_along_axis")
def put_along_axis(x, idx, values, axis):
    """Out of place: x with ``values`` set at ``idx`` along ``axis``."""
    idx = idx.long()
    values = torch.broadcast_to(torch.as_tensor(values, dtype=x.dtype,
                                                device=x.device), idx.shape)
    return x.scatter(axis, idx, values)


@register_op("numel")
def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@register_op("rank")
def rank(x):
    return torch.tensor(x.ndim, dtype=torch.int32, device=x.device)
