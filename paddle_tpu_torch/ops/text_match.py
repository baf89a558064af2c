"""The text-matching ops (ref: ``paddle_tpu/ops/text_match.py``):
``match_matrix_tensor``, ``var_conv_2d`` and
``sequence_topk_avg_pooling``, over padded dense batches with per-sample
lengths. Inside each sample's valid region they compute the reference's
math; outside it they give 0. Plain PyTorch (an einsum, a library
convolution, a stable sort), as the reference leaves them to XLA.
"""

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops.nn import conv2d
from paddle_tpu_torch.ops.rnn import top_k


def _len_mask(lengths, size):
    return (torch.arange(size, device=lengths.device)[None, :]
            < lengths[:, None])


@register_op("match_matrix_tensor")
def match_matrix_tensor(x, y, w, x_lens, y_lens, act=None):
    """Match images ``[B, T, L, R]``: ``out[b, t, i, j] = x[b, i] @ w[:,
    t, :] @ y[b, j]`` (x ``[B, L, D]``, y ``[B, R, D]``, w ``[D, T,
    D]``), 0 outside ``(x_lens[b], y_lens[b])``; ``act`` names an
    activation of ``ops/activations.py``."""
    enforce(w.ndim == 3 and x.shape[-1] == w.shape[0]
            and y.shape[-1] == w.shape[2],
            "match_matrix_tensor: w must be [D, dim_t, D] matching x/y dims")
    out = torch.einsum("bld,dte,bre->btlr", x, w, y)
    mask = (_len_mask(x_lens, x.shape[1])[:, None, :, None]
            & _len_mask(y_lens, y.shape[1])[:, None, None, :])
    out = torch.where(mask, out, 0.0)
    if act is not None:
        out = torch.where(mask, getattr(activations, act)(out), 0.0)
    return out


@register_op("var_conv_2d")
def var_conv_2d(x, row_lens, col_lens, weight, stride=1):
    """Convolution over per-sample images of their own size (ref:
    ``text_match.py:58``): x ``[B, C, H, W]`` padded, weight ``[O, C,
    kh, kw]``, the window centred (``k // 2`` before) and reading 0
    outside each sample's ``(row_lens[b], col_lens[b])``. Output ``[B,
    O, ceil(H / s), ceil(W / s)]``, 0 past ``ceil(h_b / s) x ceil(w_b /
    s)``."""
    sh = sw = stride
    if isinstance(stride, (tuple, list)):
        sh, sw = stride
    H, W = x.shape[2], x.shape[3]
    kh, kw = weight.shape[2], weight.shape[3]
    valid = (_len_mask(row_lens, H)[:, None, :, None]
             & _len_mask(col_lens, W)[:, None, None, :])
    xz = torch.where(valid, x, 0.0)
    pad = ((kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2))
    out = conv2d(xz, weight, None, (sh, sw), pad)
    out_rows = (row_lens.clamp(min=0) + sh - 1) // sh
    out_cols = (col_lens.clamp(min=0) + sw - 1) // sw
    ovalid = (_len_mask(out_rows, out.shape[2])[:, None, :, None]
              & _len_mask(out_cols, out.shape[3])[:, None, None, :])
    return torch.where(ovalid, out, 0.0)


@register_op("sequence_topk_avg_pooling")
def sequence_topk_avg_pooling(x, row_lens, col_lens, topks,
                              channel_num=None):
    """Per-row top-k column averages (ref: ``text_match.py:91``): x ``[B,
    C, H, W]`` -> ``[B, H, C * K]``, ``out[b, r, c * K + k]`` the sum of
    the ``topks[k]`` largest of ``x[b, c, r, :col_lens[b]]`` over
    ``topks[k]``; with fewer valid columns than ``topks[k]`` the sum
    takes what there is and the divisor stays ``topks[k]``. Rows past
    ``row_lens[b]`` are 0. Ties take the lower column first, as
    ``lax.top_k`` does (:func:`~paddle_tpu_torch.ops.rnn.top_k`)."""
    topks = tuple(int(k) for k in topks)
    enforce(list(topks) == sorted(topks), "topks must be ascending")
    B, C, H, W = x.shape
    if channel_num is not None:
        enforce(channel_num == C, "channel_num mismatch with x")
    max_k = min(topks[-1], W) if topks else 0
    col_ok = _len_mask(col_lens, W)[:, None, None, :]
    neg = torch.finfo(x.dtype).min
    vals, _ = top_k(torch.where(col_ok, x, neg), max(max_k, 1))
    kvalid = (torch.arange(max(max_k, 1), device=x.device)
              [None, None, None, :] < col_lens[:, None, None, None])
    csum = torch.cumsum(torch.where(kvalid, vals, 0.0), -1)
    outs = []
    for k in topks:
        idx = min(k, max_k) - 1
        s = (csum[..., idx] if idx >= 0
             else torch.zeros(csum.shape[:-1], dtype=x.dtype,
                              device=x.device))
        outs.append(s / k)
    out = torch.stack(outs, -1).permute(0, 2, 1, 3).reshape(
        B, H, C * len(topks))
    row_ok = _len_mask(row_lens, H)[:, :, None]
    return torch.where(row_ok, out, 0.0)
