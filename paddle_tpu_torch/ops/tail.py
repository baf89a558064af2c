"""The rest of the reference's ``layers/nn.py`` surface (ref:
``paddle_tpu/ops/tail.py``): small ops, each registered under the
reference's name with its signature, and the reference's alias table
(``tail.py:237-273``).

The reference's static-shape redesigns are kept (``filter_by_instag``
compacts into a fixed-size output, ``merge_selected_rows`` returns padded
unique ids). A key becomes an explicit ``torch.Generator``; a creation op
(``ones``, ``zeros``, ``create_*``, ``autoincreased_step_counter``) takes
``device=``, None meaning ``tensor_ops.placement``'s, else the card.
``hash`` computes the reference's uint32 murmur3 mix in int64 with every
product formed from 16-bit halves, so no intermediate overflows and the
ids are the reference's bit for bit on every device. ``py_func`` runs the
host function on numpy copies of its inputs, as ``jax.pure_callback``
does; ``out_shape_dtype`` is a :class:`ShapeDtype` (or a tuple of them),
the counterpart of ``jax.ShapeDtypeStruct``.
"""

import collections

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import GLOBAL_OP_REGISTRY, register_op
from paddle_tpu_torch.ops.tensor_ops import creation_device, fill_constant

#: ``py_func``'s description of an output: a shape and a dtype (a torch
#: dtype, numpy dtype or name)
ShapeDtype = collections.namedtuple("ShapeDtype", "shape dtype")


@register_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1):
    """``(1 - eps) * label + eps * prior`` (1 / K by default; ref:
    ``tail.py:19``)."""
    k = label.shape[-1]
    prior = prior_dist if prior_dist is not None else 1.0 / k
    return (1.0 - epsilon) * label + epsilon * prior


@register_op("multiplex")
def multiplex(inputs, index):
    """``out[i] = inputs[index[i]][i]`` (ref: ``tail.py:28``)."""
    stacked = torch.stack(list(inputs), 0)
    idx = index.reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


@register_op("mean_iou")
def mean_iou(prediction, label, num_classes):
    """``(mean IoU over the classes present, wrong [K], correct [K])``;
    a mismatch counts under both its prediction and its label (ref:
    ``tail.py:38``)."""
    pred = prediction.reshape(-1).long()
    lab = label.reshape(-1).long()
    ok = pred == lab

    def count(where, ids):
        hits = torch.zeros(num_classes + 1, dtype=torch.int32,
                           device=ids.device)
        idx = torch.where(where, ids, torch.full_like(ids, num_classes))
        return hits.index_add_(0, idx, torch.ones_like(
            idx, dtype=torch.int32))[:num_classes]
    correct = count(ok, lab)
    wrong = count(~ok, pred) + count(~ok, lab)
    union = correct + wrong
    present = union > 0
    iou = torch.where(present, correct / torch.clamp(union, min=1),
                      torch.zeros((), device=union.device))
    miou = iou.sum() / torch.clamp(present.sum(), min=1)
    return miou.to(torch.float32), wrong, correct


@register_op("crop_tensor")
def crop_tensor(x, shape, offsets=None):
    """The static slice of ``shape`` at ``offsets`` (zeros by default;
    ref: ``tail.py:62``)."""
    offsets = tuple(offsets) if offsets is not None else (0,) * x.ndim
    enforce(len(shape) == x.ndim and len(offsets) == x.ndim,
            "crop_tensor: shape/offsets rank mismatch")
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


@register_op("crop")
def crop(x, shape, offsets=None):
    """ref: ``tail.py:74`` (the older twin of crop_tensor)."""
    return crop_tensor(x, shape, offsets)


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(x, y, weight, bias=None):
    """``out[b, k] = x[b] W[k] y[b] + bias[k]``, W ``[K, Dx, Dy]`` (ref:
    ``tail.py:80``)."""
    out = torch.einsum("bd,kde,be->bk", x, weight, y)
    if bias is not None:
        out = out + bias
    return out


@register_op("gather_tree")
def gather_tree(ids, parents):
    """Beam-search backtrace over ``[T, B, beam]`` (ref: ``tail.py:90``):
    the ancestor id chain of each final beam."""
    t_len = ids.shape[0]
    parent = parents[t_len - 1].long()
    outs = [ids[t_len - 1]]
    for t in range(t_len - 2, -1, -1):
        outs.append(torch.take_along_dim(ids[t], parent, dim=-1))
        parent = torch.take_along_dim(parents[t], parent, dim=-1).long()
    return torch.stack(outs[::-1], 0)


_MASK32 = 0xFFFFFFFF


def _mul32(a, c):
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, from a's 16-bit halves: no product passes 2**48."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _murmur32(x):
    """The murmur3 32-bit finalizer of ``tail.py:111`` on int64 values in
    [0, 2**32)."""
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


@register_op("hash")
def hash_bucket(ids, mod_by, num_hash=1):
    """``num_hash`` murmur3-mix digests (seeded 0 .. n-1) of each id row,
    modulo ``mod_by`` -> int32 ``[rows, num_hash]`` (ref:
    ``tail.py:119``). The ids are read as uint32 (a negative int32 wraps),
    as the reference's ``astype(uint32)`` reads them."""
    flat = ids.reshape(ids.shape[0], -1).to(torch.int64) & _MASK32
    outs = []
    for seed in range(num_hash):
        h = torch.full((flat.shape[0],), (seed * 0x9E3779B9 + 1) & _MASK32,
                       dtype=torch.int64, device=flat.device)
        for j in range(flat.shape[1]):
            h = _murmur32(h ^ _murmur32(flat[:, j]))
        outs.append((h % mod_by).to(torch.int32))
    return torch.stack(outs, -1)


@register_op("soft_relu")
def soft_relu(x, threshold=40.0):
    """``log(1 + exp(clip(x)))`` (ref: ``tail.py:139``)."""
    from paddle_tpu_torch.ops.activations import _clip
    return torch.log1p(torch.exp(_clip(x, -threshold, threshold)))


@register_op("sampling_id")
def sampling_id(probs, generator):
    """One column index a row, drawn with the row's probabilities (ref:
    ``tail.py:146``; the reference samples ``log(max(p, 1e-30))``)."""
    p = torch.clamp(probs.to(torch.float32), min=1e-30)
    return torch.multinomial(p, 1, generator=generator).squeeze(-1)


@register_op("pad_constant_like")
def pad_constant_like(ref_larger, x, pad_value=0.0):
    """``x`` padded at the end of each dim to ``ref_larger``'s shape (ref:
    ``tail.py:154``)."""
    pads = []
    for r, s in reversed(list(zip(ref_larger.shape, x.shape))):
        pads += [0, r - s]
    return torch.nn.functional.pad(x, pads, value=pad_value)


def _batch_like(like, shape, batch_dim):
    shape = list(shape)
    shape[batch_dim] = like.shape[batch_dim]
    return tuple(shape)


@register_op("uniform_random_batch_size_like")
def uniform_random_batch_size_like(like, generator, shape, min=-1.0,
                                   max=1.0, batch_dim=0,
                                   dtype=torch.float32):
    """Uniform in ``[min, max)`` with ``like``'s batch dim (ref:
    ``tail.py:162``)."""
    u = torch.rand(_batch_like(like, shape, batch_dim), generator=generator,
                   device=generator.device, dtype=convert_dtype(dtype))
    return u * (max - min) + min


@register_op("gaussian_random_batch_size_like")
def gaussian_random_batch_size_like(like, generator, shape, mean=0.0,
                                    std=1.0, batch_dim=0,
                                    dtype=torch.float32):
    """ref: ``tail.py:172``."""
    return mean + std * torch.randn(_batch_like(like, shape, batch_dim),
                                    generator=generator,
                                    device=generator.device,
                                    dtype=convert_dtype(dtype))


@register_op("ctc_greedy_decoder")
def ctc_greedy_decoder(probs, lengths=None, blank=0):
    """Argmax a frame, then the CTC collapse (ref: ``tail.py:180``):
    ``(decoded [B, T], out_lengths)``."""
    from paddle_tpu_torch.ops.sequence import ctc_align
    tokens = torch.argmax(probs, -1).to(torch.int32)
    return ctc_align(tokens, lengths, blank=blank, merge_repeated=True)


@register_op("sequence_reshape")
def sequence_reshape(rb, new_dim):
    """Each sequence's ``[len, D]`` refolded to ``[len * D / new_dim,
    new_dim]`` (ref: ``tail.py:190``); every row's ``len * D`` must
    divide by ``new_dim``."""
    from paddle_tpu_torch.core.ragged import RaggedBatch
    d = rb.values.shape[-1]
    lengths = rb.row_lengths
    enforce(bool(((lengths.cpu() * d) % new_dim == 0).all()),
            "sequence_reshape: every sequence's len*D must divide new_dim")
    return RaggedBatch(rb.values.reshape(-1, new_dim),
                       ((lengths * d) // new_dim).to(lengths.dtype))


@register_op("lod_reset")
def lod_reset(rb, new_lengths):
    """The same values under a new partition (ref: ``tail.py:208``)."""
    from paddle_tpu_torch.core.ragged import RaggedBatch
    return RaggedBatch(rb.values, torch.as_tensor(
        new_lengths, device=rb.values.device).to(torch.int32))


@register_op("random_crop")
def random_crop(x, generator, shape):
    """A crop of ``shape`` at offsets drawn a dim at a time (ref:
    ``tail.py:216``)."""
    index = []
    for full, want in zip(x.shape, shape):
        enforce(want <= full, "random_crop: crop larger than input")
        off = (int(torch.randint(0, full - want + 1, (), generator=generator,
                                 device=generator.device))
               if full > want else 0)
        index.append(slice(off, off + want))
    return x[tuple(index)]


@register_op("teacher_student_sigmoid_loss")
def teacher_student_sigmoid_loss(logits, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """CTR distillation loss (ref: ``tail.py:229``): a label < 0 carries
    the teacher's score as ``-label``."""
    from paddle_tpu_torch.ops.activations import _clip
    x = _clip(logits, soft_max_lower_bound, soft_max_up_bound)
    z = torch.where(label < 0, -label, label)
    return torch.log1p(torch.exp(x)) - z * x


@register_op("continuous_value_model")
def continuous_value_model(x, use_cvm=True):
    """Each row's first two features are (show, click): ``log(show + 1)``,
    ``log(click + 1) - log(show + 1)``, the rest copied; without
    ``use_cvm`` the two columns are dropped (ref: ``tail.py:276``)."""
    if not use_cvm:
        return x[:, 2:]
    y0 = torch.log(x[:, :1] + 1.0)
    y1 = torch.log(x[:, 1:2] + 1.0) - y0
    return torch.cat([y0, y1, x[:, 2:]], 1)


@register_op("adaptive_pool3d")
def adaptive_pool3d(x, output_size, pool_type="avg"):
    """NCDHW adaptive pooling over divisible sizes (ref: ``tail.py:289``)."""
    od, oh, ow = ((output_size,) * 3 if isinstance(output_size, int)
                  else tuple(output_size))
    n, c, d, h, w = x.shape
    enforce(d % od == 0 and h % oh == 0 and w % ow == 0,
            "adaptive_pool3d requires divisible sizes")
    x6 = x.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow)
    red = (3, 5, 7)
    return torch.amax(x6, red) if pool_type == "max" else x6.mean(red)


@register_op("lod_append")
def lod_append(values, outer_lengths, inner_lengths):
    """A two-level partition over ``values`` as a NestedRagged (ref:
    ``tail.py:304``)."""
    from paddle_tpu_torch.core.ragged import NestedRagged
    return NestedRagged.from_parts(values, (outer_lengths, inner_lengths),
                                   device=values.device)


@register_op("image_resize_short")
def image_resize_short(x, out_short_len, resample="BILINEAR",
                       data_format="NCHW"):
    """Resize so the shorter edge is ``out_short_len``, keeping the aspect
    ratio (``int(v + 0.5)`` rounding; ref: ``tail.py:315``)."""
    from paddle_tpu_torch.ops.nn import interpolate
    h, w = ((x.shape[2], x.shape[3]) if data_format == "NCHW"
            else (x.shape[1], x.shape[2]))
    short = min(h, w)
    out_h = int(h * out_short_len / short + 0.5)
    out_w = int(w * out_short_len / short + 0.5)
    return interpolate(x, size=(out_h, out_w), mode=resample.lower(),
                       data_format=data_format)


@register_op("spectral_norm")
def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    """``(weight / sigma, u, v)`` after ``power_iters`` power iterations
    from ``u``, ``v`` (ref: ``tail.py:333``); differentiable through the
    iteration, as the reference's."""
    h = weight.shape[dim]
    wmat = torch.movedim(weight, dim, 0).reshape(h, -1)
    for _ in range(power_iters):
        v = wmat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wmat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ wmat @ v
    return weight / sigma, u, v


@register_op("dynamic_lstmp")
def dynamic_lstmp(x, h0, c0, w_ih, w_hh, w_proj, b=None, lengths=None,
                  reverse=False, time_major=False, proj_activation="tanh"):
    """LSTM with a recurrent projection (ref: ``tail.py:349``): the state
    fed back is ``r_t = proj_act(h_t @ w_proj)``. x ``[B, T, I]``, h0
    ``[B, P]``, c0 ``[B, H]``, w_ih ``[I, 4H]``, w_hh ``[P, 4H]``, w_proj
    ``[H, P]``; gate order i, f, g, o. Returns ``(outputs [B, T, P], (r,
    c))``. One Python step a time step (``ops/rnn.py``'s loop)."""
    from paddle_tpu_torch.ops import activations
    from paddle_tpu_torch.ops.nn import matmul
    from paddle_tpu_torch.ops.rnn import _masked_scan, lstm_cell
    if not time_major:
        x = x.transpose(0, 1)
    proj_act = ((lambda z: z) if proj_activation is None
                else getattr(activations, proj_activation))

    def step(carry, x_t):
        r, c = carry
        h, c = lstm_cell(x_t, r, c, w_ih, w_hh, b)
        return proj_act(matmul(h, w_proj)), c

    (r, c), outs = _masked_scan(step, x, (h0, c0), lengths, reverse)
    if not time_major:
        outs = outs.transpose(0, 1)
    return outs, (r, c)


@register_op("filter_by_instag")
def filter_by_instag(x, ins_tags, filter_tags, out_size=None, pad_tag=0):
    """Rows whose tags meet ``filter_tags``, compacted to the front of a
    ``[out_size or B, ...]`` output with zeros behind: ``(filtered,
    keep_mask [B], row_map [K])``, a slot past the kept rows mapping to B
    (ref: ``tail.py:385``)."""
    b = x.shape[0]
    k = out_size if out_size is not None else b
    ftags = torch.as_tensor(filter_tags, device=ins_tags.device)
    hit = torch.any((ins_tags[:, :, None] == ftags[None, None, :])
                    & (ins_tags[:, :, None] != pad_tag), dim=2).any(1)
    order = torch.argsort((~hit).to(torch.int32), stable=True)
    slots = torch.arange(k, device=x.device)
    row_map = torch.where(slots < b, order[torch.clamp(slots, max=b - 1)],
                          torch.full_like(slots, b))
    valid = (slots < b) & hit[torch.clamp(row_map, max=b - 1)]
    row_map = torch.where(valid, row_map, torch.full_like(row_map, b))
    gathered = x[torch.clamp(row_map, max=b - 1)]
    out = torch.where(valid.reshape((-1,) + (1,) * (x.ndim - 1)), gathered,
                      torch.zeros_like(gathered))
    return out, hit, row_map


@register_op("conv_shift")
def conv_shift(x, y):
    """NTM circular correlation (ref: ``tail.py:408``): ``out[i, j] =
    sum_k x[i, (j + k - (N - 1) / 2) mod M] * y[i, k]``."""
    m = x.shape[1]
    n = y.shape[1]
    half = (n - 1) // 2
    j = torch.arange(m, device=x.device)[:, None]
    k = torch.arange(n, device=x.device)[None, :]
    idx = (j + k - half) % m
    return torch.einsum("bmn,bn->bm", x[:, idx], y)


@register_op("squared_l2_distance")
def squared_l2_distance(x, y):
    """``(||x - y||^2 a row [N, 1], x - y)`` (ref: ``tail.py:424``)."""
    sub = x - y
    return torch.sum(sub * sub, -1, keepdim=True), sub


@register_op("squared_l2_norm")
def squared_l2_norm(x):
    return torch.sum(x * x)


@register_op("l1_norm")
def l1_norm(x):
    return torch.sum(torch.abs(x))


@register_op("modified_huber_loss")
def modified_huber_loss(x, y):
    """On the margin ``v = (2y - 1) x``: ``-4v`` below -1, ``(1 - v)^2``
    below 1, else 0 (ref: ``tail.py:445``)."""
    val = (2.0 * y - 1.0) * x
    zero = torch.zeros((), dtype=val.dtype, device=val.device)
    return torch.where(val < -1.0, -4.0 * val,
                       torch.where(val < 1.0, (1.0 - val) ** 2, zero))


@register_op("positive_negative_pair")
def positive_negative_pair(score, label, query_id):
    """The LTR pair counts ``(positive, negative, neutral)`` within each
    query; a score tie counts as neutral and as negative, as the reference
    counts it (ref: ``tail.py:453``)."""
    s = score.reshape(-1)
    lab = label.reshape(-1)
    q = query_id.reshape(-1)
    same_q = q[:, None] == q[None, :]
    upper = torch.triu(torch.ones_like(same_q), diagonal=1)
    pair = same_q & upper & (lab[:, None] != lab[None, :])
    prod = (s[:, None] - s[None, :]) * (lab[:, None] - lab[None, :]).to(
        s.dtype)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    pos = torch.where(pair, (prod > 0).to(s.dtype), zero).sum()
    neg = torch.where(pair, (prod <= 0).to(s.dtype), zero).sum()
    neu = torch.where(pair, (s[:, None] == s[None, :]).to(s.dtype),
                      zero).sum()
    return pos, neg, neu


def sample_logits_from(logits, labels, samples, probs,
                       remove_accidental_hits=True):
    """The arithmetic of :func:`sample_logits` on the given samples
    ``[N, T + S]`` (labels first) and their probabilities: the gathered
    logits less ``log(q)``, a sampled column equal to one of the row's
    labels pushed to -1e20."""
    t = labels.shape[1]
    out = torch.gather(logits, 1, samples.long())
    if remove_accidental_hits:
        hit = (samples[:, None, t:] == labels[:, :, None]).any(1)
        push = torch.where(hit, -1e20, 0.0).to(out.dtype)
        out = torch.cat([out[:, :t], out[:, t:] + push], 1)
    out = out - torch.log(probs)
    n = logits.shape[0]
    sampled_labels = torch.arange(t, device=logits.device)[None, :].expand(
        n, t)
    return out, sampled_labels


@register_op("sample_logits")
def sample_logits(logits, labels, num_samples, generator,
                  remove_accidental_hits=True, use_customized_samples=False,
                  customized_samples=None, customized_probabilities=None):
    """The sampled-softmax helper (ref: ``tail.py:482``): the labels and
    ``num_samples`` negatives drawn uniformly from ``generator`` (q = 1 /
    K), or the customized ``[N, T + S]`` samples and probabilities; see
    :func:`sample_logits_from`. Returns ``(sampled_logits [N, T + S],
    sampled_labels [N, T])``."""
    n, k = logits.shape
    t = labels.shape[1]
    if use_customized_samples:
        samples, probs = customized_samples, customized_probabilities
    else:
        drawn = torch.randint(0, k, (n, num_samples), generator=generator,
                              device=generator.device).to(labels.dtype)
        samples = torch.cat([labels, drawn.to(labels.device)], 1)
        probs = torch.full((n, t + num_samples), 1.0 / k, dtype=logits.dtype,
                           device=logits.device)
    return sample_logits_from(logits, labels, samples, probs,
                              remove_accidental_hits)


@register_op("similarity_focus")
def similarity_focus(x, axis, indexes):
    """ref: ``tail.py:529`` — for each (batch, index) slice ``[R, C]``,
    greedily mark ``min(R, C)`` maxima with distinct rows and columns (the
    first of equal maxima in row-major order), OR the marks over
    ``indexes`` and broadcast them to x's shape. x ``[N, A, B, C]``, axis
    1, 2 or 3."""
    enforce(x.ndim == 4, "similarity_focus expects a 4-D input")
    enforce(axis in (1, 2, 3), "axis must be 1, 2 or 3")
    perm = {1: (0, 1, 2, 3), 2: (0, 2, 1, 3), 3: (0, 3, 1, 2)}[axis]
    xt = x.permute(perm)
    n, _, r, c = xt.shape
    sel = xt[:, list(indexes)].detach()
    flat = sel.reshape(-1, r * c)
    mask = torch.zeros_like(flat)
    rows = torch.zeros(flat.shape[0], r, dtype=torch.bool, device=x.device)
    cols = torch.zeros(flat.shape[0], c, dtype=torch.bool, device=x.device)
    neg = torch.finfo(x.dtype).min
    ar = torch.arange(flat.shape[0], device=x.device)
    for _ in range(min(r, c)):
        blocked = (rows[:, :, None] | cols[:, None, :]).reshape(-1, r * c)
        at = torch.argmax(torch.where(blocked, neg, flat), -1)
        mask[ar, at] = 1.0
        rows[ar, at // c] = True
        cols[ar, at % c] = True
    merged = mask.reshape(n, len(indexes), r, c).amax(1, keepdim=True)
    out = merged.expand(xt.shape)
    return out.permute(tuple(int(i) for i in np.argsort(perm)))


@register_op("is_empty")
def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


@register_op("minus")
def minus(x, y):
    return x - y


@register_op("scatter_nd")
def scatter_nd(index, updates, shape):
    """``zeros(shape)`` with ``updates`` added at ``index [..., K]``,
    duplicates accumulating (ref: ``tail.py:587``)."""
    out = torch.zeros(tuple(shape), dtype=updates.dtype,
                      device=updates.device)
    idx = tuple(torch.movedim(index.long(), -1, 0))
    return out.index_put(idx, updates, accumulate=True)


@register_op("autoincreased_step_counter")
def autoincreased_step_counter(counter=None, device=None):
    """The counter plus one; None starts an int32 0 (ref: ``tail.py:598``:
    the reference's default without x64)."""
    if counter is None:
        counter = torch.zeros((), dtype=torch.int32,
                              device=creation_device(device))
    return counter + 1


@register_op("resize_trilinear")
def resize_trilinear(x, size=None, scale_factor=None, align_corners=False):
    """NCDHW resize, separable linear interpolation along D, H and W
    (ref: ``tail.py:610``)."""
    n, c, d, h, w = x.shape
    if size is None:
        s = ((scale_factor,) * 3 if isinstance(scale_factor, (int, float))
             else tuple(scale_factor))
        size = (int(d * s[0]), int(h * s[1]), int(w * s[2]))

    def coords(out_n, in_n):
        ar = torch.arange(out_n, device=x.device, dtype=torch.float32)
        if align_corners and out_n > 1:
            return ar * ((in_n - 1) / (out_n - 1))
        return torch.clamp((ar + 0.5) * (in_n / out_n) - 0.5, min=0.0)

    def lin(t, cs, axis):
        i0 = torch.floor(cs).long()
        i1 = torch.clamp(i0 + 1, max=t.shape[axis] - 1)
        wgt = (cs - i0).to(t.dtype)
        a = torch.index_select(t, axis, i0)
        b = torch.index_select(t, axis, i1)
        shape = [1] * t.ndim
        shape[axis] = -1
        return a + (b - a) * wgt.reshape(shape)

    for axis, (o, i) in zip((2, 3, 4), zip(size, (d, h, w))):
        x = lin(x, coords(o, i), axis)
    return x


@register_op("merge_selected_rows")
def merge_selected_rows(ids, rows):
    """Duplicate rows of a SelectedRows merged: ``(unique ids [k], merged
    rows [k, D], valid [k])``, k = ids.numel() (ref: ``tail.py:645``)."""
    from paddle_tpu_torch.parallel.sparse import segment_rowsum, unique_ids
    uniq, inv, valid = unique_ids(ids)
    return uniq, segment_rowsum(rows, inv, uniq.shape[0]), valid


@register_op("get_tensor_from_selected_rows")
def get_tensor_from_selected_rows(ids, rows, height):
    """A SelectedRows as a dense ``[height, D]`` tensor, duplicates
    accumulating (ref: ``tail.py:657``)."""
    d = rows.shape[-1]
    out = torch.zeros((height, d), dtype=rows.dtype, device=rows.device)
    return out.index_add(0, ids.reshape(-1).long(), rows.reshape(-1, d))


def _to_numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _from_host(value, spec, device):
    if isinstance(spec, (tuple, list)) and not isinstance(spec, ShapeDtype):
        return type(spec)(_from_host(v, s, device)
                          for v, s in zip(value, spec))
    out = torch.as_tensor(np.asarray(value)).to(
        device=device, dtype=convert_dtype(spec.dtype))
    enforce(tuple(out.shape) == tuple(spec.shape),
            f"py_func returned {tuple(out.shape)}, declared {spec.shape}")
    return out


@register_op("py_func")
def py_func(func, *args, out_shape_dtype):
    """``func`` run on the host on numpy copies of ``args`` (ref:
    ``tail.py:665``); its result comes back as tensors of the declared
    :class:`ShapeDtype` (or tuple of them) on the first tensor input's
    device."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  torch.device("cpu"))
    return _from_host(func(*[_to_numpy(a) for a in args]), out_shape_dtype,
                      device)


@register_op("assign")
def assign(x, output=None):
    """A copy of ``x`` (ref: ``tail.py:676``; ``output`` is the
    reference's in-place target, unused)."""
    return torch.as_tensor(x).clone()


@register_op("sums")
def sums(inputs):
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


@register_op("has_inf")
def has_inf(x):
    return torch.any(torch.isinf(x))


@register_op("has_nan")
def has_nan(x):
    return torch.any(torch.isnan(x))


@register_op("tensor_array_to_tensor")
def tensor_array_to_tensor(array, axis=1, use_stack=False):
    """The stacked ``[N, ...]`` array with its entries stacked at ``axis``
    or concatenated along it (ref: ``tail.py:702``)."""
    if use_stack:
        return torch.movedim(array, 0, axis)
    return torch.cat([array[i] for i in range(array.shape[0])], axis)


@register_op("ones")
def ones(shape, dtype=torch.float32, device=None):
    return fill_constant(shape, dtype, 1.0, device=device)


@register_op("zeros")
def zeros(shape, dtype=torch.float32, device=None):
    return fill_constant(shape, dtype, 0.0, device=device)


@register_op("create_tensor")
def create_tensor(dtype=torch.float32, shape=(), device=None):
    return torch.zeros(tuple(shape), dtype=convert_dtype(dtype),
                       device=creation_device(device))


@register_op("create_global_var")
def create_global_var(shape, value, dtype=torch.float32, device=None):
    return torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                      device=creation_device(device))


@register_op("create_parameter")
def create_parameter(shape, dtype=torch.float32, initializer=None,
                     generator=None, device=None):
    """Zeros, or the draw of ``initializer`` (``paddle_tpu_torch.
    initializer``'s ``fn(shape, gen, dtype)``), which needs an explicit
    ``generator`` as the reference needs a key (ref: ``tail.py:745``)."""
    dev = creation_device(device)
    dtype = convert_dtype(dtype)
    if initializer is None:
        return torch.zeros(tuple(shape), dtype=dtype, device=dev)
    enforce(generator is not None,
            "create_parameter with an initializer needs a torch.Generator "
            "— parameters must not share a constant default draw")
    return initializer(tuple(shape), generator, dtype).to(dev)


# --- aliases: renamed twins of present ops (reference-name parity)
def _alias(name, target):
    if name not in GLOBAL_OP_REGISTRY and target in GLOBAL_OP_REGISTRY:
        GLOBAL_OP_REGISTRY.register(name, GLOBAL_OP_REGISTRY.get(target),
                                    alias_of=target)


def register_reference_aliases():
    """Called from ``ops/__init__`` after every op module has imported,
    so targets registered later in the import order still resolve."""
    for name, target in (
            ("embedding", "lookup_table"),
            ("topk", "top_k"),
            ("image_resize", "interpolate"),
            ("resize_bilinear", "interpolate"),
            ("resize_nearest", "interpolate"),
            ("warpctc", "ctc_loss"),
            ("smooth_l1", "smooth_l1_loss"),
            ("nce", "nce_loss"),
            ("cross_entropy2", "cross_entropy"),
            ("unique", "unique_with_counts"),
            ("cvm", "continuous_value_model"),
            ("deformable_psroi_pooling", "deformable_psroi_pool"),
            ("deformable_roi_pooling", "deformable_psroi_pool"),
            ("dynamic_lstm", "lstm"),
            ("dynamic_gru", "gru"),
            ("gru_unit", "gru_cell"),
            ("lstm_unit", "lstm_cell"),
            ("While", "while_loop"),
            ("Switch", "switch_case"),
            ("IfElse", "cond"),
            ("StaticRNN", "scan"),
            ("DynamicRNN", "scan"),
            ("Print", "print"),
            ("range", "arange"),
            ("basic_gru", "gru"),
            ("basic_lstm", "lstm"),
            ("BasicGRUUnit", "gru_cell"),
            ("BasicLSTMUnit", "lstm_cell")):
        _alias(name, target)
