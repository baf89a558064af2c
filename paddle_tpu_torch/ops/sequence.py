"""Sequence ops over ragged batches (ref: ``paddle_tpu/ops/sequence.py``,
the reference's ``sequence_ops/``).

Sequences are a :class:`~paddle_tpu_torch.core.ragged.RaggedBatch`. The
pools are segment reductions (``index_add`` and ``scatter_reduce``
standing in for ``jax.ops.segment_*``); the dense conversions live on the
batch itself. Ops whose output size depends on the data
(``sequence_concat``, ``sequence_slice``, ``sequence_erase``) and the
padded width of ``sequence_conv``/``row_conv`` read lengths on the host,
as the reference does outside jit. The reference writes no Pallas kernel
here, so neither does the port.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.ragged import RaggedBatch, repeat_ids
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.nn import matmul


@register_op("sequence_mask")
def sequence_mask(lengths, maxlen=None, dtype=torch.float32):
    """``[B, maxlen]``: 1 before each length, 0 after; ``maxlen``
    defaults to the longest (a host read)."""
    maxlen = int(maxlen) if maxlen is not None else int(lengths.max())
    return (torch.arange(maxlen, device=lengths.device)[None, :]
            < lengths[:, None]).to(dtype)


def _segment_sum(v, seg, n):
    out = torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    return out.index_add(0, seg.long(), v)


def _segment_extreme(v, seg, n, reduce):
    """``jax.ops.segment_max``/``segment_min``: an empty segment keeps
    the identity, -inf/+inf for floats and the type's min/max for ints
    (``scatter_reduce`` without ``include_self`` leaves the initial value
    there)."""
    if v.dtype.is_floating_point:
        init = -math.inf if reduce == "amax" else math.inf
    else:
        info = torch.iinfo(v.dtype)
        init = info.min if reduce == "amax" else info.max
    out = torch.full((n,) + tuple(v.shape[1:]), init, dtype=v.dtype,
                     device=v.device)
    idx = seg.long().reshape((-1,) + (1,) * (v.ndim - 1)).expand_as(v)
    return out.scatter_reduce(0, idx, v, reduce, include_self=False)


def _clamped(idx, total):
    return idx.long().clamp(0, max(total - 1, 0))


@register_op("sequence_pool")
def sequence_pool(rb, pool_type="sum"):
    """Per-sequence ``sum``, ``mean``, ``sqrt`` (sum over sqrt of the
    length), ``max``, ``min``, ``first`` or ``last`` (ref:
    ``sequence.py:29``)."""
    seg = rb.segment_ids()
    n = rb.nrows
    v = rb.values
    bshape = (-1,) + (1,) * (v.ndim - 1)
    if pool_type == "sum":
        return _segment_sum(v, seg, n)
    if pool_type in ("mean", "sqrt"):
        s = _segment_sum(v, seg, n)
        cnt = torch.clamp(rb.row_lengths, min=1).to(v.dtype)
        if pool_type == "sqrt":
            cnt = torch.sqrt(cnt)
        return s / cnt.reshape(bshape)
    if pool_type == "max":
        return _segment_extreme(v, seg, n, "amax")
    if pool_type == "min":
        return _segment_extreme(v, seg, n, "amin")
    offs = rb.offsets()
    total = v.shape[0]
    if pool_type == "first":
        return v[_clamped(offs[:-1], total)]
    if pool_type == "last":
        return v[_clamped(torch.clamp(offs[1:] - 1, min=0), total)]
    raise ValueError(f"unknown pool_type {pool_type}")


@register_op("sequence_softmax")
def sequence_softmax(rb):
    """Softmax within each sequence of 1-D values, the segment's max
    subtracted first."""
    seg = rb.segment_ids()
    n = rb.nrows
    m = _segment_extreme(rb.values, seg, n, "amax")
    e = torch.exp(rb.values - m[seg.long()])
    z = _segment_sum(e, seg, n)
    return RaggedBatch(e / z[seg.long()], rb.row_lengths)


@register_op("sequence_expand")
def sequence_expand(x, rb_y):
    """Row i of ``x`` repeated ``rb_y.row_lengths[i]`` times."""
    reps = rb_y.row_lengths
    rows = torch.arange(x.shape[0], device=x.device)
    idx = repeat_ids(rows, reps.to(x.device), int(rb_y.values.shape[0]))
    return RaggedBatch(x[idx], reps)


@register_op("sequence_reverse")
def sequence_reverse(rb):
    """Each sequence reversed in place."""
    offs = rb.offsets().long()
    seg = rb.segment_ids().long()
    pos = torch.arange(rb.values.shape[0], device=rb.values.device)
    local = pos - offs[seg]
    rev_idx = offs[seg] + (rb.row_lengths.long()[seg] - 1 - local)
    return RaggedBatch(rb.values[rev_idx], rb.row_lengths)


@register_op("sequence_pad")
def sequence_pad(rb, pad_value=0.0, maxlen=None):
    """``(padded, lengths)``; ``maxlen`` defaults to the total length, as
    :meth:`RaggedBatch.to_padded`'s does."""
    dense, _ = rb.to_padded(maxlen, pad_value)
    return dense, rb.row_lengths


@register_op("sequence_unpad")
def sequence_unpad(x, lengths):
    return RaggedBatch.from_padded(x, lengths)


@register_op("sequence_concat")
def sequence_concat(rbs):
    """Row i of the result is row i of each input in turn (offsets read
    on the host)."""
    n = rbs[0].nrows
    offs = [rb.offsets().tolist() for rb in rbs]
    parts = [rb.values[o[i]:o[i + 1]]
             for i in range(n) for rb, o in zip(rbs, offs)]
    lengths = rbs[0].row_lengths
    for rb in rbs[1:]:
        lengths = lengths + rb.row_lengths
    return RaggedBatch(torch.cat(parts, 0), lengths)


@register_op("sequence_first_step")
def sequence_first_step(rb):
    return sequence_pool(rb, "first")


@register_op("sequence_last_step")
def sequence_last_step(rb):
    return sequence_pool(rb, "last")


@register_op("sequence_slice")
def sequence_slice(rb, offset, length):
    """Entries ``[offset, offset + length)`` of each sequence; ``offset``
    and ``length`` are ints or ``[B]`` tensors. As in the reference the
    values keep ``B * max(length)`` rows, the valid ones first."""
    dev = rb.values.device
    if not isinstance(offset, int):
        offset = torch.as_tensor(offset, device=dev).long()
    starts = rb.offsets()[:-1].long() + offset
    if isinstance(length, int):
        max_l = length
        lengths = torch.full((rb.nrows,), max_l, dtype=torch.int32,
                             device=dev)
    else:
        length = torch.as_tensor(length, device=dev)
        max_l = int(length.max())
        lengths = length.to(torch.int32).expand(rb.nrows)
    pos = torch.arange(max_l, device=dev)
    idx = _clamped(starts[:, None] + pos[None, :], rb.values.shape[0])
    vals = rb.values[idx.reshape(-1)]
    valid = (pos[None, :] < lengths[:, None]).reshape(-1)
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    return RaggedBatch(vals[order], lengths)


@register_op("sequence_enumerate")
def sequence_enumerate(x, win_size, pad_value=0):
    """Sliding windows ``[n, win_size]`` over 1-D ids, ``pad_value`` past
    the end."""
    n = x.shape[0]
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(win_size, device=x.device)[None, :])
    valid = idx < n
    return torch.where(valid, x[idx.clamp(0, n - 1)], pad_value)


@register_op("sequence_erase")
def sequence_erase(rb, tokens):
    """Every occurrence of ``tokens`` dropped from each sequence. Host
    numpy, as the reference's (the output size depends on the data); the
    result lies on ``rb``'s device."""
    v = rb.values.detach().cpu().numpy()
    seg = rb.segment_ids().cpu().numpy()
    keep = ~np.isin(v, np.asarray(list(tokens)))
    new_lengths = np.bincount(seg[keep], minlength=rb.nrows).astype(
        np.int32)
    dev = rb.values.device
    return RaggedBatch(torch.from_numpy(v[keep]).to(dev),
                       torch.from_numpy(new_lengths).to(dev))


@register_op("sequence_expand_as")
def sequence_expand_as(x, rb_y):
    return sequence_expand(x, rb_y)


@register_op("sequence_scatter")
def sequence_scatter(x, rb_ids, rb_updates):
    """For each row i: ``out[i, ids_i[k]] += updates_i[k]``."""
    rows = rb_ids.segment_ids().long()
    return x.index_put((rows, rb_ids.values.long()), rb_updates.values,
                       accumulate=True)


def _repack(dense, rb):
    """The valid ``[B, T, ...]`` entries of a result shaped like
    ``rb.to_padded``'s, back in ``rb``'s flat layout."""
    seg = rb.segment_ids().long()
    offs = rb.offsets()[:-1].long()
    pos = torch.arange(rb.values.shape[0], device=dense.device) - offs[seg]
    return RaggedBatch(dense[seg, pos], rb.row_lengths)


def _padded_max_len(rb, max_len):
    """``max_len``, or the longest row's length. The reference takes it
    on the host when the lengths are concrete and falls back to the flat
    total under jit; the port's lengths are always concrete, so this
    always reads the longest length on the host."""
    if max_len is not None:
        return int(max_len)
    return int(rb.row_lengths.max())


@register_op("sequence_conv")
def sequence_conv(rb, filter_w, context_start=-1, context_length=3,
                  bias=None, max_len=None):
    """Context-window projection (ref: ``sequence.py:211``): at each
    position t the rows ``t + context_start ... t + context_start +
    context_length - 1``, zero outside the sequence, concatenated and
    multiplied by ``filter_w [context_length * D, out]``."""
    dense, _ = rb.to_padded(_padded_max_len(rb, max_len))
    T = dense.shape[1]
    lengths = rb.row_lengths.to(dense.device)
    pos0 = torch.arange(T, device=dense.device)
    mask = pos0[None, :] < lengths[:, None]
    dense = torch.where(mask[..., None], dense, 0.0)
    cols = []
    for k in range(context_length):
        off = context_start + k
        shifted = torch.roll(dense, -off, dims=1)
        pos = pos0 + off
        valid = (pos >= 0)[None, :] & (pos[None, :] < lengths[:, None])
        cols.append(torch.where(valid[..., None], shifted, 0.0))
    out = matmul(torch.cat(cols, -1), filter_w)
    if bias is not None:
        out = out + bias
    return _repack(out, rb)


@register_op("row_conv")
def row_conv(rb, filter_w, max_len=None):
    """Lookahead convolution (ref: ``sequence.py:239``): ``out[t] =
    sum_k filter_w[k] * x[t + k]`` per channel, zero past the end."""
    dense, _ = rb.to_padded(_padded_max_len(rb, max_len))
    T = dense.shape[1]
    lengths = rb.row_lengths.to(dense.device)
    pos0 = torch.arange(T, device=dense.device)
    out = torch.zeros_like(dense)
    for k in range(filter_w.shape[0]):
        shifted = torch.roll(dense, -k, dims=1)
        valid = (pos0 + k)[None, :] < lengths[:, None]
        out = out + torch.where(valid[..., None], shifted, 0.0) * filter_w[k]
    mask = pos0[None, :] < lengths[:, None]
    return _repack(torch.where(mask[..., None], out, 0.0), rb)


@register_op("im2sequence")
def im2sequence(x, kernels, strides=(1, 1), paddings=(0, 0, 0, 0)):
    """Each kernel-sized patch of NCHW images as one time step: ``[N, C,
    H, W]`` -> ``[N, out_h * out_w, C * kh * kw]``; ``paddings`` is (top,
    left, bottom, right)."""
    N, C, H, W = x.shape
    kh, kw = kernels
    sh, sw = strides
    pt, pl, pb, pr = paddings
    x = F.pad(x, (pl, pr, pt, pb))
    out_h = (H + pt + pb - kh) // sh + 1
    out_w = (W + pl + pr - kw) // sw + 1
    ii = (torch.arange(out_h, device=x.device)[:, None] * sh
          + torch.arange(kh, device=x.device)[None, :])
    jj = (torch.arange(out_w, device=x.device)[:, None] * sw
          + torch.arange(kw, device=x.device)[None, :])
    patches = x[:, :, ii[:, None, :, None], jj[None, :, None, :]]
    patches = patches.permute(0, 2, 3, 1, 4, 5)
    return patches.reshape(N, out_h * out_w, C * kh * kw)


@register_op("add_position_encoding")
def add_position_encoding(x, alpha=1.0, beta=1.0):
    """``alpha * x + beta * [sin | cos]`` of the position over ``[B, T,
    D]``, the divisor ``10000 ** (k / (half - 1))`` (ref:
    ``sequence.py:281``)."""
    B, T, D = x.shape
    pos = torch.arange(T, dtype=x.dtype, device=x.device)[:, None]
    half = D // 2
    if half <= 1:
        div = torch.full((max(half, 1),), 10000.0, dtype=x.dtype,
                         device=x.device)
    else:
        div = torch.pow(10000.0, torch.arange(
            half, dtype=x.dtype, device=x.device) / (half - 1))
    enc = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], -1)
    if enc.shape[-1] < D:
        enc = F.pad(enc, (0, D - enc.shape[-1]))
    return alpha * x + beta * enc[None]


@register_op("ctc_align")
def ctc_align(tokens, lengths=None, blank=0, merge_repeated=True,
              padding_value=0):
    """CTC alignment (ref: ``sequence.py:301``): blanks dropped and, with
    ``merge_repeated``, a token equal to the raw previous one dropped.
    Returns (aligned ``[B, T]`` padded with ``padding_value``, lengths
    ``[B]`` int32). Dropped tokens are scattered into an extra column T,
    which is cut off (the reference's ``mode="drop"``)."""
    B, T = tokens.shape
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    prev = torch.cat([torch.full((B, 1), -1, dtype=tokens.dtype,
                                 device=dev), tokens[:, :-1]], 1)
    in_range = torch.arange(T, device=dev)[None, :] < lengths.to(dev)[:, None]
    keep = (tokens != blank) & in_range
    if merge_repeated:
        keep &= tokens != prev
    pos = torch.cumsum(keep.to(torch.int64), 1) - 1
    cols = torch.where(keep, pos, T)
    out = torch.full((B, T + 1), padding_value, dtype=tokens.dtype,
                     device=dev)
    out = out.scatter(1, cols, tokens)[:, :T]
    return out, keep.sum(1).to(torch.int32)
