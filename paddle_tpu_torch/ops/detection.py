"""Detection ops (ref: ``paddle_tpu/ops/detection.py``): box geometry,
priors and anchors, NMS, matching and the SSD loss, RoI ops, YOLOv3,
proposals and anchor/RoI targets.

Plain PyTorch on the tensors' own device: the reference wrote no Pallas
kernel for any of them (XLA fused them), so no kernel of the port runs
here. Every output keeps the reference's static shape: NMS and proposal
outputs are padded (with -1, or index 0 and a False mask) beside an
explicit valid count or mask.

Where the reference relies on an order, the port reproduces it:
``jnp.argsort`` is stable and ``lax.top_k`` puts the lower index first
among equal values, so every sort here is a stable one (a descending
stable sort, sliced, stands for ``lax.top_k``); ``torch.argmax`` returns
the first maximum, as ``jnp.argmax`` does.

Greedy NMS (:func:`_nms_keep_mask`) is one loop over the score-sorted
candidates, with any leading dimensions (classes) batched; the loop reads
nothing back to the host. The matching and the SSD loss take a leading
batch dimension where the reference ``vmap``s over images.

A product with a boolean mask in the reference (``x * mask``) is a
select there (``-inf * False`` is 0, not NaN), so it is ``torch.where``
here.

Randomness (the subsampling of :func:`rpn_target_assign` and
:func:`generate_proposal_labels`) comes from an explicit
``torch.Generator``; ``test_uniforms`` replaces its draws, so a parity
test can feed in the reference's threefry draws. Indices and labels are
int64.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op


def _like(value, ref):
    """``value`` (a number, sequence or tensor) as a tensor of ``ref``'s
    dtype on ``ref``'s device."""
    return torch.as_tensor(value, dtype=ref.dtype, device=ref.device)


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``; bounds may be
    numbers or tensors (``hi`` None: no upper bound)."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        x = torch.maximum(x, _like(lo, x))
        return x if hi is None else torch.minimum(x, _like(hi, x))
    return torch.clamp(x, lo, hi)


def _sort_desc(x, dim=-1):
    """(values, indices) in descending order, the lower index first among
    equal values: ``jnp.argsort(-x)``'s and ``lax.top_k``'s order."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


def _argsort(x, dim=-1):
    """``jnp.argsort``: ascending and stable."""
    return torch.sort(x, dim=dim, stable=True).indices


def _rank(x, dim=-1):
    """``jnp.argsort(jnp.argsort(x))``: each entry's place in x's stable
    ascending order (the inverse permutation of the sort)."""
    order = _argsort(x, dim)
    pos = torch.arange(x.shape[dim], device=x.device).expand_as(order)
    return torch.empty_like(order).scatter_(dim, order, pos)


def _gather_rows(x, idx):
    """``x[..., idx, :]`` per leading index: x ``[..., N, K]``, idx
    ``[..., M]`` -> ``[..., M, K]``."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape,
                                                     x.shape[-1]))


# ------------------------------------------------------------------ IoU
@register_op("iou_similarity")
def iou_similarity(x, y, box_normalized=True):
    """Pairwise IoU between x ``[..., N, 4]`` and y ``[..., M, 4]`` ->
    ``[..., N, M]`` (ref: ``detection.py:32``)."""
    offset = 0.0 if box_normalized else 1.0
    ax1, ay1, ax2, ay2 = (x[..., :, k, None] for k in range(4))   # [N,1]
    bx1, by1, bx2, by2 = (y[..., None, :, k] for k in range(4))   # [1,M]
    area_x = (ax2 - ax1 + offset) * (ay2 - ay1 + offset)
    area_y = (bx2 - bx1 + offset) * (by2 - by1 + offset)
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)
                     + offset, min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1)
                     + offset, min=0.0)
    inter = iw * ih
    union = area_x + area_y - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                       torch.zeros_like(inter))


@register_op("box_clip")
def box_clip(boxes, im_shape):
    """Clip ``[..., 4]`` boxes to the image ``(h, w)`` (ref: ``:51``)."""
    h, w = im_shape[0], im_shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([_clip(x1, 0.0, w - 1.0), _clip(y1, 0.0, h - 1.0),
                        _clip(x2, 0.0, w - 1.0), _clip(y2, 0.0, h - 1.0)],
                       dim=-1)


# ------------------------------------------------------------------ box_coder
@register_op("box_coder")
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              bbox_clip=None):
    """Encode or decode boxes against priors ``[M, 4]`` (ref: ``:64``).

    encode_center_size: target ``[..., N, 4]`` -> ``[..., N, M, 4]``.
    decode_center_size: deltas ``[N, M, 4]`` (or ``[N, 4]``) -> boxes,
    the priors along dim 1 (``axis=0``) or dim 0 (``axis=1``).
    ``prior_box_var``: None, ``[4]`` or ``[M, 4]``."""
    norm = 0.0 if box_normalized else 1.0
    pw = prior_box[:, 2] - prior_box[:, 0] + norm
    ph = prior_box[:, 3] - prior_box[:, 1] + norm
    pcx = prior_box[:, 0] + pw * 0.5
    pcy = prior_box[:, 1] + ph * 0.5
    if prior_box_var is None:
        var = torch.ones((prior_box.shape[0], 4), dtype=prior_box.dtype,
                         device=prior_box.device)
    else:
        var = _like(prior_box_var, prior_box).broadcast_to(
            (prior_box.shape[0], 4))

    if code_type == "encode_center_size":
        tw = target_box[..., 2] - target_box[..., 0] + norm
        th = target_box[..., 3] - target_box[..., 1] + norm
        tcx = target_box[..., 0] + tw * 0.5
        tcy = target_box[..., 1] + th * 0.5
        dx = (tcx[..., :, None] - pcx) / pw / var[:, 0]
        dy = (tcy[..., :, None] - pcy) / ph / var[:, 1]
        dw = torch.log(tw[..., :, None] / pw) / var[:, 2]
        dh = torch.log(th[..., :, None] / ph) / var[:, 3]
        return torch.stack([dx, dy, dw, dh], dim=-1)

    enforce(code_type == "decode_center_size",
            "unknown code_type %s" % code_type)
    t = target_box
    if t.ndim == 2:
        t = t[:, None, :] if axis == 0 else t[None, :, :]
    if axis == 0:   # priors broadcast along rows
        pcx_, pcy_, pw_, ph_ = pcx[None, :], pcy[None, :], pw[None, :], \
            ph[None, :]
        v = var[None, :, :]
    else:           # axis == 1: priors along the first dim
        pcx_, pcy_, pw_, ph_ = pcx[:, None], pcy[:, None], pw[:, None], \
            ph[:, None]
        v = var[:, None, :]
    cx = v[..., 0] * t[..., 0] * pw_ + pcx_
    cy = v[..., 1] * t[..., 1] * ph_ + pcy_
    dw = v[..., 2] * t[..., 2]
    dh = v[..., 3] * t[..., 3]
    if bbox_clip is not None:
        dw = torch.clamp(dw, max=bbox_clip)
        dh = torch.clamp(dh, max=bbox_clip)
    w = torch.exp(dw) * pw_
    h = torch.exp(dh) * ph_
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - norm, cy + h * 0.5 - norm], dim=-1)


# ------------------------------------------------------------------ priors
def expand_aspect_ratios(aspect_ratios, flip):
    """SSD aspect-ratio expansion, deduplicated, with 1/ar under ``flip``
    (ref: ``:118``); shared by :func:`prior_box` and ``MultiBoxHead``."""
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    return ars


def _cell_centers(fh, fw, step_h, step_w, offset, device):
    """``[H, W, 1, 2]`` centers ``((j + offset) * step_w, (i + offset) *
    step_h)`` of a feature map's cells."""
    cx = (torch.arange(fw, dtype=torch.float32, device=device) + offset) \
        * step_w
    cy = (torch.arange(fh, dtype=torch.float32, device=device) + offset) \
        * step_h
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    return torch.stack([cxg, cyg], -1)[:, :, None, :]


def _scaled(boxes, ih, iw, clip, variance):
    boxes = boxes / torch.tensor([iw, ih, iw, ih], dtype=torch.float32,
                                 device=boxes.device)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=boxes.device).expand(boxes.shape)
    return boxes, var


@register_op("prior_box")
def prior_box(feature_shape, image_shape, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, device="cuda"):
    """SSD prior boxes for one feature map (ref: ``:131``):
    ``feature_shape`` and ``image_shape`` are static ``(h, w)``. Returns
    (boxes ``[H, W, P, 4]``, variances ``[H, W, P, 4]``) on ``device``."""
    device = resolve_device(device)
    fh, fw = feature_shape
    ih, iw = image_shape
    ars = expand_aspect_ratios(aspect_ratios, flip)
    step_w = steps[1] if steps[1] > 0 else float(iw) / fw
    step_h = steps[0] if steps[0] > 0 else float(ih) / fh
    max_sizes = list(max_sizes or [])
    whs = []
    for k, ms in enumerate(min_sizes):
        base = [(float(ms), float(ms))]
        rest = [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars
                if abs(ar - 1.0) > 1e-6]
        if max_sizes:
            sq = float(np.sqrt(ms * max_sizes[k]))
            if min_max_aspect_ratios_order:
                whs += base + [(sq, sq)] + rest
            else:
                whs += base + rest + [(sq, sq)]
        else:
            whs += base + rest
    wh = torch.tensor(np.asarray(whs, np.float64), dtype=torch.float32,
                      device=device)                       # [P,2]
    c = _cell_centers(fh, fw, step_h, step_w, offset, device)
    half = wh[None, None, :, :] / 2.0
    boxes = torch.cat([c - half, c + half], dim=-1)
    return _scaled(boxes, ih, iw, clip, variance)


@register_op("density_prior_box")
def density_prior_box(feature_shape, image_shape, fixed_sizes, fixed_ratios,
                      densities, variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, device="cuda"):
    """Densified priors (ref: ``:176``) -> (boxes ``[H, W, P, 4]``,
    variances)."""
    device = resolve_device(device)
    fh, fw = feature_shape
    ih, iw = image_shape
    step_w = steps[1] if steps[1] > 0 else float(iw) / fw
    step_h = steps[0] if steps[0] > 0 else float(ih) / fh
    step_avg = int((step_w + step_h) * 0.5)
    entries = []  # (shift_x, shift_y, w, h) per prior, from the cell center
    for size, density in zip(fixed_sizes, densities):
        shift = int(step_avg / density)
        for ratio in fixed_ratios:
            bw = size * np.sqrt(ratio)
            bh = size / np.sqrt(ratio)
            for di in range(density):
                for dj in range(density):
                    sx = -step_avg / 2.0 + shift / 2.0 + dj * shift
                    sy = -step_avg / 2.0 + shift / 2.0 + di * shift
                    entries.append((sx, sy, bw, bh))
    ent = torch.tensor(np.asarray(entries, np.float64), dtype=torch.float32,
                       device=device)                      # [P,4]
    center = _cell_centers(fh, fw, step_h, step_w, offset, device)
    ctr = center + ent[None, None, :, :2]
    half = ent[None, None, :, 2:] / 2.0
    boxes = torch.cat([ctr - half, ctr + half], dim=-1)
    return _scaled(boxes, ih, iw, clip, variance)


@register_op("anchor_generator")
def anchor_generator(feature_shape, anchor_sizes, aspect_ratios, stride,
                     variance=(0.1, 0.1, 0.2, 0.2), offset=0.5,
                     device="cuda"):
    """RPN anchors for one level -> (anchors ``[H, W, A, 4]``, variances)
    in the pixel-inclusive convention (ref: ``:214``)."""
    device = resolve_device(device)
    fh, fw = feature_shape
    whs = []
    for ar in aspect_ratios:
        for s in anchor_sizes:
            area = (stride[0] * stride[1])
            area_ratios = area / ar
            base_w = np.round(np.sqrt(area_ratios))
            base_h = np.round(base_w * ar)
            scale_w = s / stride[0]
            scale_h = s / stride[1]
            whs.append((scale_w * base_w, scale_h * base_h))
    wh = torch.tensor(np.asarray(whs, np.float64), dtype=torch.float32,
                      device=device)                       # [A,2]
    cx = torch.arange(fw, dtype=torch.float32, device=device) * stride[0] \
        + offset * (stride[0] - 1.0)
    cy = torch.arange(fh, dtype=torch.float32, device=device) * stride[1] \
        + offset * (stride[1] - 1.0)
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    c = torch.stack([cxg, cyg], -1)[:, :, None, :]
    half = (wh[None, None, :, :] - 1.0) / 2.0
    anchors = torch.cat([c - half, c + half], dim=-1)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=device).expand(anchors.shape)
    return anchors, var


# ------------------------------------------------------------------ NMS
def _nms_keep_mask(boxes, scores, iou_threshold, box_normalized=True):
    """Greedy NMS over score-sorted boxes ``[..., n, 4]`` (any leading
    dimensions, e.g. classes, run together) -> (keep mask ``[..., n]`` in
    SORTED order, the sort order). One device loop over the candidates,
    the reference's ``fori_loop`` (ref: ``:246``): step i drops every
    later box whose IoU with box i passes the threshold, if box i is still
    kept."""
    n = boxes.shape[-2]
    order = _sort_desc(scores).indices
    b = _gather_rows(boxes, order)
    iou = iou_similarity(b, b, box_normalized=box_normalized)
    idx = torch.arange(n, device=boxes.device)
    spared = ~((iou > iou_threshold) & (idx[None, :] > idx[:, None]))
    keep = torch.ones(order.shape, dtype=torch.bool, device=boxes.device)
    kept = torch.ones_like(keep)       # a tensor, not a scalar: two
    for i in range(n):                 # launches a step, not three
        keep &= torch.where(keep[..., i, None], spared[..., i, :], kept)
    return keep, order


@register_op("nms")
def nms(boxes, scores, iou_threshold=0.3, score_threshold=-math.inf,
        keep_top_k=-1, box_normalized=True):
    """Single-class NMS -> (indices ``[K]``, valid mask ``[K]``), K static:
    ``keep_top_k`` if > 0, else N; invalid slots hold index 0 and False
    (ref: ``:264``)."""
    n = boxes.shape[0]
    k = n if keep_top_k is None or keep_top_k < 0 else min(keep_top_k, n)
    keep, order = _nms_keep_mask(boxes, scores, iou_threshold,
                                 box_normalized)
    keep = keep & (scores[order] > score_threshold)
    # stable select: kept entries keep their (sorted) rank, dropped go last
    rank = torch.where(keep, torch.arange(n, device=boxes.device), n)
    srt = _argsort(rank)
    return order[srt[:k]], keep[srt][:k]


@register_op("multiclass_nms")
def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, background_label=-1,
                   box_normalized=True, return_index=False):
    """Multi-class NMS with a static output (ref: ``:280``).

    bboxes: ``[N, 4]`` (shared across classes) or ``[N, C, 4]``; scores
    ``[C, N]``. Returns out ``[keep_top_k, 6]`` rows (label, score, x1, y1,
    x2, y2) padded with -1 and the valid count (a 0-d tensor), with the
    kept rows' box indices (-1 padded) between them under
    ``return_index``. Every class's NMS runs in one batched loop."""
    num_classes, n = scores.shape
    dev = scores.device
    if bboxes.ndim == 2:
        bboxes = bboxes[:, None, :].expand(n, num_classes, 4)
    pre_k = min(nms_top_k, n) if nms_top_k > 0 else n
    # top nms_top_k by score first (ref NMSFast top_k), then greedy NMS
    top_scores, top_idx = _sort_desc(scores)
    top_scores, top_idx = top_scores[:, :pre_k], top_idx[:, :pre_k]
    cls_boxes = _gather_rows(bboxes.transpose(0, 1), top_idx)  # [C,pre_k,4]
    keep, order = _nms_keep_mask(cls_boxes, top_scores, nms_threshold,
                                 box_normalized)
    cls_scores = torch.gather(top_scores, 1, order)
    cls_keep = keep & (cls_scores > score_threshold)
    cls_idx = torch.gather(top_idx, 1, order)
    labels = torch.arange(num_classes, device=dev)[:, None].expand(
        num_classes, pre_k)
    if background_label >= 0:
        cls_keep = cls_keep & (labels != background_label)
    flat_scores = torch.where(cls_keep, cls_scores,
                              -math.inf).reshape(-1)
    flat_labels = labels.reshape(-1)
    flat_idx = cls_idx.reshape(-1)
    k = min(keep_top_k if keep_top_k > 0 else flat_scores.shape[0],
            flat_scores.shape[0])
    top_scores, top = _sort_desc(flat_scores)
    top_scores, top = top_scores[:k], top[:k]
    valid = top_scores > -math.inf
    sel_label = flat_labels[top]
    sel_idx = flat_idx[top]
    sel_box = bboxes[sel_idx, sel_label]
    out = torch.cat([sel_label[:, None].to(bboxes.dtype),
                     top_scores[:, None], sel_box], dim=-1)
    out = torch.where(valid[:, None], out, -1.0)
    if return_index:
        return out, torch.where(valid, sel_idx, -1), valid.sum()
    return out, valid.sum()


@register_op("multiclass_nms2")
def multiclass_nms2(bboxes, scores, score_threshold=0.0, nms_top_k=400,
                    keep_top_k=100, nms_threshold=0.3, background_label=-1,
                    box_normalized=True):
    """:func:`multiclass_nms` that also returns the kept rows' input box
    indices, -1 for padding (ref: ``:1014``)."""
    return multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold, background_label,
                          box_normalized, return_index=True)


@register_op("detection_output")
def detection_output(loc, scores, prior_box, prior_box_var,
                     nms_threshold=0.3, nms_top_k=400, keep_top_k=200,
                     score_threshold=0.01, background_label=0):
    """SSD post-processing (ref: ``:1029``): decode the deltas ``loc [N,
    4]`` against their priors ``[N, 4]`` one to one, then
    :func:`multiclass_nms` of the class probabilities ``scores [N, C]``.
    Returns (out ``[keep_top_k, 6]``, count)."""
    decoded = box_coder(prior_box, prior_box_var, loc[:, None, :],
                        code_type="decode_center_size", axis=1)
    decoded = decoded.reshape(-1, 4)
    return multiclass_nms(decoded, scores.T, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold, background_label)


# ------------------------------------------------------------------ RoI ops
def _take_yx(img, yi, xi):
    """``img[..., :, yi][..., xi]``: img ``[..., C, H, W]``, yi ``[...,
    Ny]``, xi ``[..., Nx]`` (int64) -> ``[..., C, Ny, Nx]``."""
    *lead, c, h, w = img.shape
    rows = torch.gather(img, -2, yi[..., None, :, None].expand(
        *lead, c, yi.shape[-1], w))
    return torch.gather(rows, -1, xi[..., None, None, :].expand(
        *lead, c, yi.shape[-1], xi.shape[-1]))


def _bilinear_sample(img, ys, xs):
    """img ``[..., C, H, W]``; ys ``[..., Ny]``, xs ``[..., Nx]`` ->
    ``[..., C, Ny, Nx]`` bilinear, zero outside (ref: ``:365``)."""
    h, w = img.shape[-2:]
    y_ok = (ys >= -1.0) & (ys <= h)
    x_ok = (xs >= -1.0) & (xs <= w)
    y = torch.clamp(ys, 0.0, h - 1.0)
    x = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly = (y - y0)[..., None, :, None]
    lx = (x - x0)[..., None, None, :]
    v00 = _take_yx(img, y0, x0)
    v01 = _take_yx(img, y0, x1)
    v10 = _take_yx(img, y1, x0)
    v11 = _take_yx(img, y1, x1)
    out = (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx
           + v10 * ly * (1 - lx) + v11 * ly * lx)
    return torch.where(y_ok[..., None, :, None] & x_ok[..., None, None, :],
                       out, 0.0)


@register_op("roi_align")
def roi_align(x, rois, roi_batch_idx, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, aligned=False):
    """RoIAlign (ref: ``:329``). x ``[B, C, H, W]``; rois ``[R, 4]``
    (x1, y1, x2, y2 in image coordinates); roi_batch_idx ``[R]`` ->
    ``[R, C, ph, pw]``. ``sampling_ratio`` <= 0 is a static 2 samples a
    bin, as in the reference."""
    c = x.shape[1]
    ph, pw = pooled_height, pooled_width
    s = sampling_ratio if sampling_ratio > 0 else 2
    roi_offset = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (rois * spatial_scale - roi_offset).unbind(-1)
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_w = (roi_w / pw)[:, None, None]
    bin_h = (roi_h / ph)[:, None, None]
    ar = lambda n: torch.arange(n, dtype=x.dtype, device=x.device)  # noqa
    sy = y1[:, None, None] + (ar(ph)[:, None] * bin_h
                              + (ar(s)[None, :] + 0.5) * bin_h / s)
    sx = x1[:, None, None] + (ar(pw)[:, None] * bin_w
                              + (ar(s)[None, :] + 0.5) * bin_w / s)
    img = x[roi_batch_idx.long()]                              # [R,C,H,W]
    vals = _bilinear_sample(img, sy.reshape(len(rois), -1),
                            sx.reshape(len(rois), -1))
    return vals.reshape(len(rois), c, ph, s, pw, s).mean(dim=(3, 5))


@register_op("roi_pool")
def roi_pool(x, rois, roi_batch_idx, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    """RoI max pool over quantized bins (ref: ``:388``) -> ``[R, C, ph,
    pw]``; an empty bin gives 0."""
    h, w = x.shape[2:]
    ph, pw = pooled_height, pooled_width
    x1, y1, x2, y2 = (torch.round(rois[:, k] * spatial_scale)
                      for k in range(4))
    roi_h = torch.clamp(y2 - y1 + 1, min=1.0)
    roi_w = torch.clamp(x2 - x1 + 1, min=1.0)
    bin_h = (roi_h / ph)[:, None, None]
    bin_w = (roi_w / pw)[:, None, None]
    img = x[roi_batch_idx.long()]                              # [R,C,H,W]
    ar = lambda n: torch.arange(n, dtype=x.dtype, device=x.device)  # noqa
    pi = ar(ph)[:, None]
    pj = ar(pw)[:, None]
    y1, x1 = y1[:, None, None], x1[:, None, None]
    ys_lo = torch.clamp(torch.floor(pi * bin_h + y1), 0, h)
    ys_hi = torch.clamp(torch.ceil((pi + 1) * bin_h + y1), 0, h)
    xs_lo = torch.clamp(torch.floor(pj * bin_w + x1), 0, w)
    xs_hi = torch.clamp(torch.ceil((pj + 1) * bin_w + x1), 0, w)
    my = (ar(h) >= ys_lo) & (ar(h) < ys_hi)                    # [R,ph,H]
    mx = (ar(w) >= xs_lo) & (ar(w) < xs_hi)                    # [R,pw,W]
    m = my[:, :, None, :, None] & mx[:, None, :, None, :]      # [R,ph,pw,H,W]
    masked = torch.where(m[:, None], img[:, :, None, None, :, :],
                         -math.inf)
    out = masked.amax(dim=(-1, -2))                            # [R,C,ph,pw]
    return torch.where(torch.isfinite(out), out, 0.0)


@register_op("roi_perspective_transform")
def roi_perspective_transform(x, rois, roi_batch_idx, transformed_height,
                              transformed_width, spatial_scale=1.0):
    """Perspective-warp quadrilateral RoIs ``[R, 8]`` (x0, y0, ..., x3, y3
    clockwise from the top left) to a fixed ``th x tw`` grid (ref:
    ``:921``). Returns (out ``[R, C, th, tw]``, mask ``[R, 1, th, tw]``),
    0 where the source falls outside the image or the quad."""
    th, tw = int(transformed_height), int(transformed_width)
    _, C, H, W = x.shape
    R = rois.shape[0]
    q = rois.reshape(-1, 4, 2) * spatial_scale
    rx, ry = q[..., 0], q[..., 1]                              # [R, 4]

    def lengths(a, b):
        return torch.sqrt(torch.sum((q[:, a] - q[:, b]) ** 2, dim=-1))
    est_w = (lengths(0, 1) + lengths(2, 3)) / 2.0
    est_h = (lengths(1, 2) + lengths(3, 0)) / 2.0
    nh = torch.tensor(float(max(2, th)), dtype=x.dtype, device=x.device)
    nw = torch.clamp(torch.round(est_w * (nh - 1) / torch.clamp(
        est_h, min=1e-5)).to(torch.int32) + 1, 2, tw).to(x.dtype)
    dx1 = rx[:, 1] - rx[:, 2]
    dx2 = rx[:, 3] - rx[:, 2]
    dx3 = rx[:, 0] - rx[:, 1] + rx[:, 2] - rx[:, 3]
    dy1 = ry[:, 1] - ry[:, 2]
    dy2 = ry[:, 3] - ry[:, 2]
    dy3 = ry[:, 0] - ry[:, 1] + ry[:, 2] - ry[:, 3]
    den = dx1 * dy2 - dx2 * dy1 + 1e-5
    m6 = (dx3 * dy2 - dx2 * dy3) / den / (nw - 1)
    m7 = (dx1 * dy3 - dx3 * dy1) / den / (nh - 1)
    m3 = (ry[:, 1] - ry[:, 0] + m6 * (nw - 1) * ry[:, 1]) / (nw - 1)
    m4 = (ry[:, 3] - ry[:, 0] + m7 * (nh - 1) * ry[:, 3]) / (nh - 1)
    m5 = ry[:, 0]
    m0 = (rx[:, 1] - rx[:, 0] + m6 * (nw - 1) * rx[:, 1]) / (nw - 1)
    m1 = (rx[:, 3] - rx[:, 0] + m7 * (nh - 1) * rx[:, 3]) / (nh - 1)
    m2 = rx[:, 0]

    ow = torch.arange(tw, dtype=x.dtype, device=x.device)[None, None, :]
    oh = torch.arange(th, dtype=x.dtype, device=x.device)[None, :, None]
    e = lambda v: v[:, None, None]  # noqa: E731
    u = e(m0) * ow + e(m1) * oh + e(m2)
    v = e(m3) * ow + e(m4) * oh + e(m5)
    w_ = e(m6) * ow + e(m7) * oh + 1.0
    in_w = u / w_                                              # [R, th, tw]
    in_h = v / w_
    valid = ((in_w >= -0.5) & (in_w <= W - 0.5)
             & (in_h >= -0.5) & (in_h <= H - 0.5)
             & (ow <= e(nw) - 1) & (w_ > 1e-6))

    flat = x[roi_batch_idx.long()].reshape(R, C, H * W)
    in_w_c = torch.clamp(in_w, 0.0, W - 1.0)
    in_h_c = torch.clamp(in_h, 0.0, H - 1.0)
    x0 = torch.floor(in_w_c)
    y0 = torch.floor(in_h_c)
    fx = in_w_c - x0
    fy = in_h_c - y0
    acc = torch.zeros((R, C, th, tw), dtype=x.dtype, device=x.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yy = y0 + dy
            xx = x0 + dx
            ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            wgt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy))
            wgt = torch.where(ok, wgt, 0.0)
            xi = torch.clamp(xx, 0, W - 1).long()
            yi = torch.clamp(yy, 0, H - 1).long()
            idx = (yi * W + xi).reshape(R, 1, -1).expand(R, C, th * tw)
            acc = acc + torch.gather(flat, 2, idx).reshape(R, C, th, tw) \
                * wgt[:, None]
    out = torch.where(valid[:, None], acc, 0.0)
    return out, valid[:, None].to(x.dtype)


# ------------------------------------------------------------------ YOLO
@register_op("yolo_box")
def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0):
    """Decode a YOLOv3 head (ref: ``:427``). x ``[B, A*(5+cls), H, W]``;
    img_size ``[B, 2]`` (h, w) -> (boxes ``[B, H*W*A, 4]``, scores ``[B,
    H*W*A, cls]``)."""
    bsz, _, h, w = x.shape
    na = len(anchors) // 2
    an = _like(anchors, x).reshape(na, 2)                      # [A,2] (w,h)
    x = x.reshape(bsz, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    gy = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    bias = (scale_x_y - 1.0) * 0.5
    cx = (torch.sigmoid(x[:, :, 0]) * scale_x_y - bias + gx) / w
    cy = (torch.sigmoid(x[:, :, 1]) * scale_x_y - bias + gy) / h
    input_h = downsample_ratio * h
    input_w = downsample_ratio * w
    bw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] / input_w
    bh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] / input_h
    conf = torch.sigmoid(x[:, :, 4])
    conf = torch.where(conf < conf_thresh, 0.0, conf)
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    imh = img_size[:, 0].to(x.dtype)[:, None, None, None]
    imw = img_size[:, 1].to(x.dtype)[:, None, None, None]
    x1 = (cx - bw / 2.0) * imw
    y1 = (cy - bh / 2.0) * imh
    x2 = (cx + bw / 2.0) * imw
    y2 = (cy + bh / 2.0) * imh
    if clip_bbox:
        x1 = _clip(x1, 0.0, imw - 1)
        y1 = _clip(y1, 0.0, imh - 1)
        x2 = _clip(x2, 0.0, imw - 1)
        y2 = _clip(y2, 0.0, imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)              # [B,A,H,W,4]
    boxes = boxes.permute(0, 2, 3, 1, 4).reshape(bsz, h * w * na, 4)
    scores = probs.permute(0, 3, 4, 1, 2).reshape(bsz, h * w * na, class_num)
    nonzero = conf.permute(0, 2, 3, 1).reshape(bsz, -1) > 0
    return torch.where(nonzero[..., None], boxes, 0.0), scores


def _abs(x):
    """|x| with ``jnp.abs``'s gradient at 0 (+1; ``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _bce_logit(x, t):
    """``maximum(x, 0) - x t + log1p(exp(-|x|))``, with the reference's
    gradients at 0 (``ops/loss.py sigmoid_cross_entropy_with_logits``)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.maximum(x, zero) - x * t + torch.log1p(torch.exp(-_abs(x)))


@register_op("yolov3_loss")
def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh=0.7, downsample_ratio=32, use_label_smooth=False):
    """YOLOv3 training loss of one detection head (ref: ``:469``).

    x ``[B, A*(5+cls), H, W]``; gt_box ``[B, G, 4]`` (cx, cy, w, h,
    relative; zero rows pad); gt_label ``[B, G]`` -> loss per image
    ``[B]``: objectness BCE with the ignore mask, coordinates weighted by
    (2 - w h), class BCE; each gt goes to its best anchor by wh-IoU, in
    its grid cell."""
    bsz, _, h, w = x.shape
    dev = x.device
    namask = len(anchor_mask)
    an_all = torch.tensor(anchors, dtype=torch.float32,
                          device=dev).reshape(-1, 2)
    mask_arr = torch.tensor(anchor_mask, device=dev)
    an = an_all[mask_arr]                                      # [A,2]
    x = x.reshape(bsz, namask, 5 + class_num, h, w)
    input_w = downsample_ratio * w
    input_h = downsample_ratio * h

    px = torch.sigmoid(x[:, :, 0])                             # [B,A,H,W]
    py = torch.sigmoid(x[:, :, 1])
    pw_ = x[:, :, 2]
    ph_ = x[:, :, 3]
    pobj = x[:, :, 4]
    pcls = x[:, :, 5:]                                         # [B,A,cls,H,W]

    gxx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None]
    gyy = torch.arange(h, dtype=torch.float32,
                       device=dev)[None, None, :, None]
    pred_cx = (px + gxx) / w
    pred_cy = (py + gyy) / h
    pred_w = torch.exp(pw_) * an[None, :, 0, None, None] / input_w
    pred_h = torch.exp(ph_) * an[None, :, 1, None, None] / input_h

    gt_valid = (gt_box[..., 2] > 0) & (gt_box[..., 3] > 0)     # [B,G]

    def cxcywh_iou(b1, b2):
        b1x1, b1x2 = b1[..., 0] - b1[..., 2] / 2, b1[..., 0] + b1[..., 2] / 2
        b1y1, b1y2 = b1[..., 1] - b1[..., 3] / 2, b1[..., 1] + b1[..., 3] / 2
        b2x1, b2x2 = b2[..., 0] - b2[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2
        b2y1, b2y2 = b2[..., 1] - b2[..., 3] / 2, b2[..., 1] + b2[..., 3] / 2
        iw = torch.clamp(torch.minimum(b1x2, b2x2)
                         - torch.maximum(b1x1, b2x1), min=0)
        ih = torch.clamp(torch.minimum(b1y2, b2y2)
                         - torch.maximum(b1y1, b2y1), min=0)
        inter = iw * ih
        union = (b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3] - inter)
        return inter / torch.clamp(union, min=1e-10)

    # ignore mask: predictions whose best-gt IoU passes the threshold get
    # no no-object loss
    pred = torch.stack([pred_cx, pred_cy, pred_w, pred_h], -1)
    iou_pg = cxcywh_iou(pred[:, :, :, :, None, :],
                        gt_box[:, None, None, None, :, :])     # [B,A,H,W,G]
    iou_pg = torch.where(gt_valid[:, None, None, None, :], iou_pg, 0.0)
    ignore = iou_pg.amax(-1) > ignore_thresh                   # [B,A,H,W]

    # each gt's best anchor over ALL anchors by wh IoU at the origin
    gwh = gt_box[..., 2:4]                                     # [B,G,2]
    awh_all = an_all / torch.tensor([input_w, input_h], dtype=torch.float32,
                                    device=dev)
    inter = (torch.minimum(gwh[:, :, None, 0], awh_all[None, None, :, 0])
             * torch.minimum(gwh[:, :, None, 1], awh_all[None, None, :, 1]))
    union = (gwh[..., 0] * gwh[..., 1])[:, :, None] + \
        (awh_all[:, 0] * awh_all[:, 1])[None, None, :] - inter
    best_anchor = torch.argmax(inter / torch.clamp(union, min=1e-10), -1)
    hit = best_anchor[..., None] == mask_arr                   # [B,G,A]
    local = torch.argmax(hit.to(torch.int32), -1)
    assigned = gt_valid & hit.any(-1)                          # [B,G]

    gi = torch.clamp((gt_box[..., 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gt_box[..., 1] * h).to(torch.int32), 0, h - 1).long()
    tx = gt_box[..., 0] * w - gi
    ty = gt_box[..., 1] * h - gj
    best_wh = an_all[best_anchor]                              # [B,G,2]
    tw = torch.log(torch.clamp(gwh[..., 0] * input_w, min=1e-9)
                   / best_wh[..., 0])
    th = torch.log(torch.clamp(gwh[..., 1] * input_h, min=1e-9)
                   / best_wh[..., 1])
    box_scale = 2.0 - gwh[..., 0] * gwh[..., 1]

    def bce_p(p, t):
        p = torch.clamp(p, 1e-7, 1 - 1e-7)
        return -(t * torch.log(p) + (1 - t) * torch.log(1 - p))

    smooth_delta = 1.0 / class_num if use_label_smooth else 0.0
    asg = assigned.to(torch.float32)
    cell = (local * h + gj) * w + gi                           # [B,G]
    obj_t = torch.zeros((bsz, namask * h * w), dtype=torch.float32,
                        device=dev)
    obj_t = obj_t.scatter_reduce(1, cell, asg, reduce="amax",
                                 include_self=True).reshape(
                                     bsz, namask, h, w)

    def at_cell(v):                                            # [B,A,H,W]
        return torch.gather(v.reshape(bsz, -1), 1, cell)       # -> [B,G]
    lx = bce_p(at_cell(px), tx)
    ly = bce_p(at_cell(py), ty)
    lw = _abs(at_cell(pw_) - tw)
    lh = _abs(at_cell(ph_) - th)
    coord = ((lx + ly) * box_scale + (lw + lh) * box_scale) * asg
    onehot = F.one_hot(gt_label.long(), class_num).to(torch.float32)
    onehot = onehot * (1 - smooth_delta) + smooth_delta * 0.5
    cls_rows = pcls.permute(0, 1, 3, 4, 2).reshape(bsz, -1, class_num)
    lcls = _bce_logit(_gather_rows(cls_rows, cell), onehot).sum(-1) * asg
    lobj = _bce_logit(pobj, obj_t)
    noobj = (obj_t == 0) & ~ignore
    obj_loss = torch.where(obj_t > 0, lobj, 0.0).sum((1, 2, 3)) + \
        torch.where(noobj, lobj, 0.0).sum((1, 2, 3))
    return coord.sum(-1) + lcls.sum(-1) + obj_loss


# ------------------------------------------------------------------ proposals
@register_op("generate_proposals")
def generate_proposals(scores, bbox_deltas, anchors, variances, im_shape,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.7, min_size=0.0):
    """RPN proposals for ONE image (ref: ``:583``). scores ``[A]``;
    bbox_deltas, anchors, variances ``[A, 4]``; im_shape ``(h, w)`` ->
    (rois ``[post_nms_top_n, 4]``, roi scores, valid mask)."""
    a = scores.shape[0]
    pre_k = min(pre_nms_top_n, a)
    top_scores, top = _sort_desc(scores)
    top_scores, top = top_scores[:pre_k], top[:pre_k]
    deltas = bbox_deltas[top]
    anc = anchors[top]
    var = variances[top]
    aw = anc[:, 2] - anc[:, 0] + 1.0
    ah = anc[:, 3] - anc[:, 1] + 1.0
    acx = anc[:, 0] + aw * 0.5
    acy = anc[:, 1] + ah * 0.5
    cx = var[:, 0] * deltas[:, 0] * aw + acx
    cy = var[:, 1] * deltas[:, 1] * ah + acy
    w = torch.exp(torch.clamp(var[:, 2] * deltas[:, 2], max=10.0)) * aw
    h = torch.exp(torch.clamp(var[:, 3] * deltas[:, 3], max=10.0)) * ah
    props = torch.stack([cx - w * 0.5, cy - h * 0.5,
                         cx + w * 0.5 - 1.0, cy + h * 0.5 - 1.0], -1)
    props = box_clip(props, im_shape)
    ww = props[:, 2] - props[:, 0] + 1.0
    hh = props[:, 3] - props[:, 1] + 1.0
    alive = (ww >= max(min_size, 1.0)) & (hh >= max(min_size, 1.0))
    sc = torch.where(alive, top_scores, -math.inf)
    keep, order = _nms_keep_mask(props, sc, nms_thresh, box_normalized=False)
    keep = keep & (sc[order] > -math.inf)
    rank = torch.where(keep, torch.arange(pre_k, device=scores.device),
                       pre_k)
    srt = _argsort(rank)
    sel = srt[:post_nms_top_n]
    valid = keep[srt][:post_nms_top_n]
    rois = torch.where(valid[:, None], props[order][sel], 0.0)
    return rois, torch.where(valid, sc[order][sel], 0.0), valid


# ------------------------------------------------------------------ matching
@register_op("bipartite_match")
def bipartite_match(dist, match_type="bipartite", overlap_threshold=0.5):
    """Greedy bipartite matching on similarities ``[..., N_gt, M]``
    (ref: ``:625``): min(N, M) times, bind the global maximum's row and
    column if it is positive; ``per_prediction`` then also matches each
    unmatched column whose best row passes ``overlap_threshold``. Returns
    (match indices ``[..., M]``, -1 unmatched; match distances)."""
    *lead, n, m = dist.shape
    d = dist.reshape(-1, n, m)
    bf = d.shape[0]
    dev = dist.device
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    midx = torch.full((bf, m), -1, dtype=torch.long, device=dev)
    mdist = torch.zeros((bf, m), dtype=dist.dtype, device=dev)
    for _ in range(min(n, m)):
        flat = d.reshape(bf, -1)
        at = torch.argmax(flat, dim=1)
        i, j = at // m, at % m
        val = torch.gather(flat, 1, at[:, None])[:, 0]
        ok = val > 0
        col = cols == j[:, None]                               # [bf, m]
        hit = ok[:, None] & col
        midx = torch.where(hit, i[:, None], midx)
        mdist = torch.where(hit, val[:, None], mdist)
        drop = ok[:, None, None] & ((rows[:, None] == i[:, None, None])
                                    | col[:, None, :])
        d = d.masked_fill(drop, -1.0)
    midx = midx.reshape(*lead, m)
    mdist = mdist.reshape(*lead, m)
    if match_type == "per_prediction":
        best_val, best_row = dist.max(dim=-2)
        extra = (midx < 0) & (best_val > overlap_threshold)
        midx = torch.where(extra, best_row, midx)
        mdist = torch.where(extra, best_val, mdist)
    return midx, mdist


@register_op("target_assign")
def target_assign(x, match_indices, mismatch_value=0.0):
    """Per-prior targets gathered by match index (ref: ``:659``): x
    ``[..., N_gt, K]``, match_indices ``[..., M]`` (-1 unmatched) -> (out
    ``[..., M, K]``, weight ``[..., M, 1]``)."""
    matched = match_indices >= 0
    safe = torch.clamp(match_indices, 0, x.shape[-2] - 1).long()
    out = torch.where(matched[..., None], _gather_rows(x, safe),
                      _like(mismatch_value, x))
    return out, matched.to(x.dtype)[..., None]


@register_op("mine_hard_examples")
def mine_hard_examples(neg_loss, match_indices, neg_pos_ratio=3.0,
                       min_neg=1):
    """Hard-negative mask, max_negative mode (ref: ``:672``): per row of
    ``[..., M]``, the ``max(int(positives * ratio), min_neg)`` unmatched
    priors of largest loss (equal losses: the lower index first)."""
    pos = match_indices >= 0
    num_pos = pos.sum(-1, keepdim=True)
    num_neg = torch.clamp((num_pos * neg_pos_ratio).to(torch.int32),
                          min=min_neg)
    masked = torch.where(pos, -math.inf, neg_loss.detach())
    return (~pos) & (_rank(-masked) < num_neg)


@register_op("ssd_loss")
def ssd_loss(location, confidence, gt_box, gt_label, prior_box_,
             prior_var=None, overlap_threshold=0.5, neg_pos_ratio=3.0,
             background_label=0, loc_loss_weight=1.0, conf_loss_weight=1.0):
    """SSD multibox loss (ref: ``:688``): IoU, per-prediction bipartite
    matching, target assignment, softmax loss with hard-negative mining
    and smooth-L1 on the matched priors, over the matched count.

    location ``[B, M, 4]``, confidence ``[B, M, C]``, gt_box ``[B, G, 4]``
    (normalized x1y1x2y2, zero rows pad), gt_label ``[B, G]`` -> ``[B]``;
    without the leading dimension, one image's scalar."""
    from paddle_tpu_torch.ops.loss import (smooth_l1_loss,
                                           softmax_with_cross_entropy)
    if location.ndim == 2:
        return ssd_loss(location[None], confidence[None], gt_box[None],
                        gt_label[None], prior_box_, prior_var,
                        overlap_threshold, neg_pos_ratio, background_label,
                        loc_loss_weight, conf_loss_weight)[0]
    b, m = location.shape[:2]
    valid_gt = (gt_box[..., 2] > gt_box[..., 0]) & \
        (gt_box[..., 3] > gt_box[..., 1])                      # [B,G]
    sim = iou_similarity(gt_box, prior_box_)                   # [B,G,M]
    sim = torch.where(valid_gt[..., None], sim, -1.0)
    midx, _ = bipartite_match(sim, "per_prediction", overlap_threshold)
    # zero-padded gt rows would hit log(0) in the encoder, and -inf * 0 is
    # NaN in the backward of the where below: swap them for a unit box
    # (never matched) first
    safe_gt = torch.where(valid_gt[..., None], gt_box,
                          _like([0.0, 0.0, 1.0, 1.0], gt_box))
    enc = box_coder(prior_box_, prior_var, safe_gt,
                    code_type="encode_center_size")            # [B,G,M,4]
    g = torch.clamp(midx, 0, gt_box.shape[1] - 1)              # [B,M]
    loc_t = torch.gather(enc, 1, g[:, None, :, None].expand(b, 1, m, 4))[:, 0]
    matched = midx >= 0
    conf_t = torch.where(matched, torch.gather(gt_label.long(), 1, g),
                         background_label)
    conf_l = softmax_with_cross_entropy(confidence, conf_t[..., None])[..., 0]
    neg_sel = mine_hard_examples(conf_l, midx, neg_pos_ratio)
    conf_loss = torch.where(matched | neg_sel, conf_l, 0.0).sum(-1)
    loc_l = smooth_l1_loss(location.reshape(b * m, 4),
                           loc_t.reshape(b * m, 4)).reshape(b, m)
    loc_loss = torch.where(matched, loc_l, 0.0).sum(-1)
    n = torch.clamp(matched.sum(-1), min=1).to(location.dtype)
    return (conf_loss_weight * conf_loss + loc_loss_weight * loc_loss) / n


@register_op("distribute_fpn_proposals")
def distribute_fpn_proposals(rois, min_level=2, max_level=5, refer_level=4,
                             refer_scale=224):
    """Each RoI's FPN level, ``floor(refer + log2(sqrt(area) /
    refer_scale))`` clipped (ref: ``:726``) -> (level ``[R]``, one-hot
    ``[R, L]``)."""
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = torch.sqrt(torch.clamp(w * h, min=1e-12))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-9)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).long()
    mask = F.one_hot(lvl - min_level, max_level - min_level + 1).to(
        torch.float32)
    return lvl, mask


@register_op("box_decoder_and_assign")
def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           bbox_clip=4.135):
    """Per-class decode, then each RoI's box of its best non-background
    class (ref: ``:742``). prior_box ``[R, 4]``; target_box ``[R, C*4]``;
    box_score ``[R, C]`` -> (decode_box ``[R, C*4]``, assign_box ``[R,
    4]``)."""
    R = prior_box.shape[0]
    C = box_score.shape[1]
    decode = box_coder(prior_box, prior_box_var, target_box.reshape(R, C, 4),
                       code_type="decode_center_size", box_normalized=False,
                       axis=1, bbox_clip=bbox_clip)            # [R,C,4]
    if C > 1:
        best = torch.argmax(box_score[:, 1:], dim=1) + 1        # [R]
        assign = decode[torch.arange(R, device=decode.device), best]
    else:
        assign = prior_box
    return decode.reshape(R, C * 4), assign


def _match_anchors(anchors, gt_boxes, gt_valid, pos_threshold,
                   neg_threshold):
    """Anchor-to-gt matching with the epsilon-tie best-anchor rule (ref:
    ``:774``) -> (pos, neg, argmax_gt, max_iou)."""
    iou = iou_similarity(anchors, gt_boxes, box_normalized=False)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    max_iou, argmax_gt = iou.max(dim=1)
    pos = max_iou >= pos_threshold
    gt_max = iou.amax(dim=0)
    tie = (iou >= gt_max[None, :] - 1e-5) & gt_valid[None, :] & \
        (gt_max[None, :] > -1.0)
    pos = pos | tie.any(dim=1)
    neg = (max_iou < neg_threshold) & ~pos
    return pos, neg, argmax_gt, max_iou


def _uniforms(generator, n, like, test_uniforms):
    """Two draws of ``n`` uniforms on ``like``'s device: from
    ``generator``, or ``test_uniforms`` (a pair given by a parity test)."""
    if test_uniforms is not None:
        return tuple(_like(u, like) for u in test_uniforms)
    dev = generator.device if generator is not None else like.device
    return tuple(torch.rand(n, generator=generator, device=dev).to(
        like.device) for _ in range(2))


@register_op("rpn_target_assign")
def rpn_target_assign(generator, anchors, gt_boxes, gt_valid=None,
                      rpn_batch_size_per_im=256, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
                      test_uniforms=None):
    """RPN anchor targets for one image (ref: ``:793``): positives (IoU >=
    the positive overlap, or a gt's best anchor), negatives (max IoU below
    the negative overlap), subsampled to ``rpn_batch_size_per_im`` with at
    most ``rpn_fg_fraction`` positives by random ranks drawn from
    ``generator``. Returns (labels ``[A]``: 1 fg, 0 bg, -1 ignored;
    bbox_targets ``[A, 4]``). ``test_uniforms``: the two ``[A]`` draws
    given instead, for parity tests against the reference's draws."""
    A = anchors.shape[0]
    G = gt_boxes.shape[0]
    if gt_valid is None:
        gt_valid = torch.ones((G,), dtype=torch.bool, device=anchors.device)
    pos, neg, argmax_gt, _ = _match_anchors(
        anchors, gt_boxes, gt_valid, rpn_positive_overlap,
        rpn_negative_overlap)
    u1, u2 = _uniforms(generator, A, anchors, test_uniforms)
    fg_cap = int(rpn_batch_size_per_im * rpn_fg_fraction)
    pos_sel = pos & (_rank(torch.where(pos, u1, 2.0)) < fg_cap)
    neg_cap = rpn_batch_size_per_im - pos_sel.sum()
    neg_sel = neg & (_rank(torch.where(neg, u2, 2.0)) < neg_cap)
    labels = torch.where(pos_sel, 1, torch.where(neg_sel, 0, -1))
    deltas = _encode_center_size(anchors, gt_boxes[argmax_gt])
    return labels, torch.where(pos_sel[:, None], deltas, 0.0)


def _encode_center_size(anchors, gts, eps=1e-8):
    """encode_center_size deltas with +1 sizes (ref: ``:843``)."""
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    gw = gts[:, 2] - gts[:, 0] + 1
    gh = gts[:, 3] - gts[:, 1] + 1
    gcx = gts[:, 0] + gw / 2
    gcy = gts[:, 1] + gh / 2
    return torch.stack([
        (gcx - acx) / torch.clamp(aw, min=eps),
        (gcy - acy) / torch.clamp(ah, min=eps),
        torch.log(torch.clamp(gw, min=eps) / torch.clamp(aw, min=eps)),
        torch.log(torch.clamp(gh, min=eps) / torch.clamp(ah, min=eps)),
    ], dim=1)


@register_op("generate_proposal_labels")
def generate_proposal_labels(generator, rois, gt_classes, gt_boxes,
                             gt_valid=None, batch_size_per_im=512,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             class_num=81,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             test_uniforms=None):
    """RoI sampling and targets for the R-CNN head (ref: ``:862``): fg if
    max IoU >= fg_thresh (at most fg_fraction of the batch), bg if in
    [bg_thresh_lo, bg_thresh_hi); random ranks from ``generator`` (or
    ``test_uniforms``, as in :func:`rpn_target_assign`). Returns (labels
    ``[R]``: class for sampled fg, 0 sampled bg, -1 ignored;
    bbox_targets ``[R, class_num*4]``; fg_mask; bg_mask)."""
    R = rois.shape[0]
    G = gt_boxes.shape[0]
    if gt_valid is None:
        gt_valid = torch.ones((G,), dtype=torch.bool, device=rois.device)
    iou = iou_similarity(rois, gt_boxes, box_normalized=False)
    # padded gt columns read 0.0, so a gt-free image still yields
    # background samples
    iou = torch.where(gt_valid[None, :], iou, 0.0)
    max_iou, argmax_gt = iou.max(dim=1)
    fg = max_iou >= fg_thresh
    bg = (max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo) & ~fg
    u1, u2 = _uniforms(generator, R, rois, test_uniforms)
    fg_cap = int(batch_size_per_im * fg_fraction)
    fg_sel = fg & (_rank(torch.where(fg, u1, 2.0)) < fg_cap)
    bg_cap = batch_size_per_im - fg_sel.sum()
    bg_sel = bg & (_rank(torch.where(bg, u2, 2.0)) < bg_cap)
    cls = gt_classes.long()[argmax_gt]
    labels = torch.where(fg_sel, cls, torch.where(bg_sel, 0, -1))
    deltas = _encode_center_size(rois, gt_boxes[argmax_gt]) / _like(
        bbox_reg_weights, rois)                                # [R, 4]
    tgt = torch.zeros((R, class_num, 4), dtype=deltas.dtype,
                      device=rois.device)
    tgt[torch.arange(R, device=rois.device),
        torch.clamp(cls, 0, class_num - 1)] = torch.where(
            fg_sel[:, None], deltas, 0.0)
    return labels, tgt.reshape(R, class_num * 4), fg_sel, bg_sel


@register_op("retinanet_target_assign")
def retinanet_target_assign(anchors, gt_boxes, gt_labels, gt_valid=None,
                            positive_overlap=0.5, negative_overlap=0.4):
    """RetinaNet anchor targets (ref: ``:1048``): the RPN rules with no
    subsampling and class labels. Returns (labels ``[A]``: gt class fg, 0
    bg, -1 ignored; bbox_targets ``[A, 4]``; fg_mask)."""
    G = gt_boxes.shape[0]
    if gt_valid is None:
        gt_valid = torch.ones((G,), dtype=torch.bool, device=anchors.device)
    pos, neg, argmax_gt, _ = _match_anchors(
        anchors, gt_boxes, gt_valid, positive_overlap, negative_overlap)
    cls = gt_labels.long()[argmax_gt]
    labels = torch.where(pos, cls, torch.where(neg, 0, -1))
    deltas = _encode_center_size(anchors, gt_boxes[argmax_gt])
    return labels, torch.where(pos[:, None], deltas, 0.0), pos
