"""Vision ops of the detection family (ref: ``paddle_tpu/ops/vision.py``:
``polygon_box_transform``, ``psroi_pool``, ``prroi_pool``,
``deformable_psroi_pool``, ``collect_fpn_proposals``,
``sigmoid_focal_loss`` and ``retinanet_detection_output``), in plain
PyTorch as dense gathers over all RoIs at once, where the reference
``vmap``s over them. The sampling grids, deformable convolution, 3-D ops
and video ops of that module (``:25-251``, ``:272``) are not ported.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.detection import _sort_desc, multiclass_nms


def _ar(n, like):
    return torch.arange(n, dtype=like.dtype, device=like.device)


@register_op("polygon_box_transform")
def polygon_box_transform(x):
    """EAST geometry map (ref: ``:260``): even channels ``4 w - v``, odd
    channels ``4 h - v``."""
    _, C, H, W = x.shape
    ws = _ar(W, x).expand(H, W)
    hs = _ar(H, x)[:, None].expand(H, W)
    even = torch.arange(C, device=x.device) % 2 == 0
    coord = torch.where(even[:, None, None], 4.0 * ws, 4.0 * hs)
    return coord[None] - x


@register_op("psroi_pool")
def psroi_pool(x, rois, roi_batch_ids, output_channels, pooled_height,
               pooled_width, spatial_scale=1.0):
    """Position-sensitive RoI average pooling (R-FCN; ref: ``:335``): x
    ``[N, out_c*ph*pw, H, W]``, rois ``[R, 4]`` in image coordinates ->
    ``[R, out_c, ph, pw]``."""
    H, W = x.shape[2:]
    ph, pw = pooled_height, pooled_width
    oc = output_channels
    x1 = torch.round(rois[:, 0]) * spatial_scale
    y1 = torch.round(rois[:, 1]) * spatial_scale
    x2 = torch.round(rois[:, 2] + 1.0) * spatial_scale
    y2 = torch.round(rois[:, 3] + 1.0) * spatial_scale
    bin_w = torch.clamp(x2 - x1, min=0.1) / pw
    bin_h = torch.clamp(y2 - y1, min=0.1) / ph
    xs, ys = _ar(W, x), _ar(H, x)
    xr = x[roi_batch_ids.long()]                               # [R,C,H,W]
    cells = []
    for i in range(ph):
        for j in range(pw):
            hs = torch.floor(y1 + i * bin_h)
            he = torch.ceil(y1 + (i + 1) * bin_h)
            ws_ = torch.floor(x1 + j * bin_w)
            we = torch.ceil(x1 + (j + 1) * bin_w)
            hmask = (ys[None, :] >= hs[:, None]) & (ys[None, :] < he[:, None])
            wmask = (xs[None, :] >= ws_[:, None]) & (xs[None, :] < we[:, None])
            m = (hmask[:, :, None] & wmask[:, None, :]).to(x.dtype)
            cnt = torch.clamp(m.sum(dim=(1, 2)), min=1.0)      # [R]
            # bin (i, j) reads channel c*ph*pw + i*pw + j of group c
            chan = torch.arange(oc, device=x.device) * ph * pw + i * pw + j
            s = torch.sum(xr[:, chan] * m[:, None], dim=(2, 3))  # [R,oc]
            cells.append(s / cnt[:, None])
    return torch.stack(cells, dim=-1).reshape(len(rois), oc, ph, pw)


def _hat_integral(a, b, n, like):
    """The integral of ``max(0, 1 - |t - j|)`` over [a, b] for every pixel
    j in [0, n); a, b ``[..., P, 1]`` -> ``[..., P, n]``; pixels outside
    contribute 0."""
    j = _ar(n, like)
    lo = torch.minimum(torch.maximum(a, j - 1.0), j)
    hi = torch.minimum(torch.maximum(b, j - 1.0), j)
    left = ((hi - (j - 1.0)) ** 2 - (lo - (j - 1.0)) ** 2) * 0.5
    lo2 = torch.minimum(torch.maximum(a, j), j + 1.0)
    hi2 = torch.minimum(torch.maximum(b, j), j + 1.0)
    right = ((j + 1.0 - lo2) ** 2 - (j + 1.0 - hi2) ** 2) * 0.5
    return left + right


@register_op("prroi_pool")
def prroi_pool(x, rois, roi_batch_ids, pooled_height=1, pooled_width=1,
               spatial_scale=1.0):
    """Precise RoI pooling (ref: ``:377``): each bin the exact integral of
    the bilinearly interpolated map over the bin, over its area, as one
    einsum of separable hat-basis coefficients. x ``[B, C, H, W]``; rois
    ``[R, 4]`` -> ``[R, C, ph, pw]``."""
    H, W = x.shape[2:]
    ph, pw = pooled_height, pooled_width
    x1, y1, x2, y2 = (rois.to(x.dtype) * spatial_scale).unbind(-1)
    bin_w = (torch.clamp(x2 - x1, min=0.0) / pw)[:, None, None]
    bin_h = (torch.clamp(y2 - y1, min=0.0) / ph)[:, None, None]
    win_size = torch.clamp(bin_w * bin_h, min=0.0)[:, :, :, None]
    pi = _ar(ph, x)[:, None]
    pj = _ar(pw, x)[:, None]
    y1, x1 = y1[:, None, None], x1[:, None, None]
    cy = _hat_integral(y1 + pi * bin_h, y1 + (pi + 1.0) * bin_h, H, x)
    cx = _hat_integral(x1 + pj * bin_w, x1 + (pj + 1.0) * bin_w, W, x)
    out = torch.einsum("rchw,rph,rqw->rcpq", x[roi_batch_ids.long()], cy, cx)
    return torch.where(win_size > 0.0,
                       out / torch.clamp(win_size, min=1e-30), 0.0)


@register_op("deformable_psroi_pool")
def deformable_psroi_pool(x, rois, roi_batch_ids, trans=None, output_dim=1,
                          group_size=(1, 1), pooled_height=1, pooled_width=1,
                          part_size=(1, 1), sample_per_part=1,
                          spatial_scale=1.0, trans_std=0.1, no_trans=False):
    """Deformable position-sensitive RoI pooling (ref: ``:428``): each bin
    averages an S x S grid of bilinear samples of its channel group,
    shifted by the learned offsets ``trans [R, 2*classes, part_h,
    part_w]``. x ``[B, output_dim*gh*gw, H, W]`` -> (out ``[R, output_dim,
    ph, pw]``, sample counts)."""
    _, C, H, W = x.shape
    gh, gw = group_size
    part_h, part_w = part_size
    ph, pw = pooled_height, pooled_width
    S = sample_per_part
    R = rois.shape[0]
    dev = x.device
    no_trans = no_trans or trans is None
    num_classes = 1 if no_trans else trans.shape[1] // 2
    channels_each = output_dim // num_classes
    ghi = np.clip(np.floor(np.arange(ph) * gh / ph), 0, gh - 1).astype(int)
    gwi = np.clip(np.floor(np.arange(pw) * gw / pw), 0, gw - 1).astype(int)
    phi = torch.as_tensor(np.floor(np.arange(ph) / ph * part_h).astype(int),
                          device=dev)
    pwi = torch.as_tensor(np.floor(np.arange(pw) / pw * part_w).astype(int),
                          device=dev)
    cidx = torch.as_tensor(
        (np.arange(output_dim)[:, None, None] * gh + ghi[None, :, None]) * gw
        + gwi[None, None, :], device=dev)                      # [O,ph,pw]
    class_id = torch.arange(output_dim, device=dev) // channels_each

    r = rois.to(x.dtype)
    e = lambda v: v[:, None, None, None]  # noqa: E731  [R] -> [R,1,1,1]
    x1 = e(torch.round(r[:, 0]) * spatial_scale - 0.5)
    y1 = e(torch.round(r[:, 1]) * spatial_scale - 0.5)
    x2 = e((torch.round(r[:, 2]) + 1.0) * spatial_scale - 0.5)
    y2 = e((torch.round(r[:, 3]) + 1.0) * spatial_scale - 0.5)
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    bin_w = roi_w / pw
    bin_h = roi_h / ph
    sub_w = bin_w / S
    sub_h = bin_h / S
    if no_trans:
        tx = ty = torch.zeros((R, output_dim, ph, pw), dtype=x.dtype,
                              device=dev)
    else:
        tr = trans.to(x.dtype)
        tx = tr[:, 2 * class_id][:, :, phi][:, :, :, pwi] * trans_std
        ty = tr[:, 2 * class_id + 1][:, :, phi][:, :, :, pwi] * trans_std
    wstart = (_ar(pw, x)[None, None, None, :] * bin_w + x1
              + tx * roi_w)[..., None, None]                   # [R,O,ph,pw,1,1]
    hstart = (_ar(ph, x)[None, None, :, None] * bin_h + y1
              + ty * roi_h)[..., None, None]
    wpos = wstart + _ar(S, x) * sub_w[..., None, None]         # [..,1,S]
    hpos = hstart + _ar(S, x)[:, None] * sub_h[..., None, None]  # [..,S,1]
    ok = ((wpos >= -0.5) & (wpos <= W - 0.5)
          & (hpos >= -0.5) & (hpos <= H - 0.5))                # [R,O,ph,pw,S,S]
    wc = torch.clamp(wpos, 0.0, W - 1.0)
    hc = torch.clamp(hpos, 0.0, H - 1.0)
    h0 = torch.floor(hc).long()
    w0 = torch.floor(wc).long()
    h1 = torch.clamp(h0 + 1, max=H - 1)
    w1 = torch.clamp(w0 + 1, max=W - 1)
    lh = hc - h0
    lw = wc - w0
    img = x[roi_batch_ids.long()].reshape(R, -1)               # [R, C*H*W]
    ch = cidx[None, :, :, :, None, None]

    def at(hh, ww):
        idx = ((ch * H + hh) * W + ww).expand(ok.shape).reshape(R, -1)
        return torch.gather(img, 1, idx).reshape(ok.shape)
    val = (at(h0, w0) * (1 - lh) * (1 - lw) + at(h0, w1) * (1 - lh) * lw
           + at(h1, w0) * lh * (1 - lw) + at(h1, w1) * lh * lw)
    val = torch.where(ok, val, 0.0)
    cnt = ok.to(x.dtype).sum(dim=(-1, -2))                     # [R,O,ph,pw]
    s = val.sum(dim=(-1, -2))
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0), cnt


@register_op("collect_fpn_proposals")
def collect_fpn_proposals(multi_rois, multi_scores, post_nms_top_n):
    """Concatenate per-level proposals and keep the global top N by score
    (ref: ``:522``; equal scores: the lower index first)."""
    rois = torch.cat(list(multi_rois), dim=0)
    scores = torch.cat(list(multi_scores), dim=0)
    k = min(post_nms_top_n, scores.shape[0])
    top_s, idx = _sort_desc(scores)
    return rois[idx[:k]], top_s[:k]


@register_op("sigmoid_focal_loss")
def sigmoid_focal_loss(logits, labels, fg_num, gamma=2.0, alpha=0.25):
    """RetinaNet focal loss (ref: ``:533``): logits ``[N, C]``; labels
    ``[N]`` in [0, C] with 0 the background (class c is column c - 1);
    normalized by ``fg_num``."""
    C = logits.shape[1]
    target = (labels[:, None] == torch.arange(1, C + 1,
                                              device=logits.device)[None, :])
    target = target.to(logits.dtype)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    p = torch.sigmoid(logits)
    ce = (target * torch.logaddexp(-logits, zero)
          + (1.0 - target) * torch.logaddexp(logits, zero))
    p_t = target * p + (1.0 - target) * (1.0 - p)
    alpha_t = target * alpha + (1.0 - target) * (1.0 - alpha)
    loss = alpha_t * torch.pow(1.0 - p_t, gamma) * ce
    fg = torch.as_tensor(fg_num, dtype=logits.dtype, device=logits.device)
    return loss / torch.clamp(fg, min=1.0)


@register_op("retinanet_detection_output")
def retinanet_detection_output(bboxes_list, scores_list, anchors_list,
                               im_info, score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3):
    """RetinaNet post-processing (ref: ``:552``): per FPN level the top
    ``nms_top_k`` anchors by best class score, their deltas decoded and
    clipped to the image, then one multi-class NMS over the levels.
    Returns (``[keep_top_k, 6]`` padded with -1, count)."""

    def decode(anchors, deltas):
        aw = anchors[:, 2] - anchors[:, 0] + 1.0
        ah = anchors[:, 3] - anchors[:, 1] + 1.0
        acx = anchors[:, 0] + aw * 0.5
        acy = anchors[:, 1] + ah * 0.5
        cx = deltas[:, 0] * aw + acx
        cy = deltas[:, 1] * ah + acy
        w = torch.exp(deltas[:, 2]) * aw
        h = torch.exp(deltas[:, 3]) * ah
        return torch.stack([cx - w * 0.5, cy - h * 0.5,
                            cx + w * 0.5 - 1.0, cy + h * 0.5 - 1.0], dim=1)

    decoded, scs = [], []
    h, w = im_info[0], im_info[1]
    for deltas, scores, anchors in zip(bboxes_list, scores_list,
                                       anchors_list):
        k = min(nms_top_k, scores.shape[0])
        idx = _sort_desc(scores.amax(dim=1)).indices[:k]
        d = decode(anchors[idx], deltas[idx])
        lim = torch.stack([torch.as_tensor(v, dtype=d.dtype, device=d.device)
                           for v in (w - 1, h - 1, w - 1, h - 1)])
        d = torch.minimum(torch.maximum(d, torch.zeros_like(lim)), lim)
        decoded.append(d)
        scs.append(scores[idx])
    boxes = torch.cat(decoded, dim=0)
    scores = torch.cat(scs, dim=0)
    return multiclass_nms(boxes, scores.T, score_threshold=score_threshold,
                          nms_top_k=-1, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, background_label=-1,
                          box_normalized=False)

