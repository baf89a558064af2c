"""Vision ops (ref: ``paddle_tpu/ops/vision.py``), in plain PyTorch.

The sampling grids (``affine_grid``, ``grid_sampler``) and the deformable
convolution use the reference's own bilinear sampler
(:func:`_bilinear_sample`): ``align_corners=True`` coordinates, zero
padding, and a corner exactly on the border keeps its weight; the
deformable convolution is its im2col form, one product over every tap.
``max_pool2d_with_index`` returns the flat index into each image's
``H * W`` plane, the first maximum of a window in row-major order (the
lowest index) on a tie, on every device; its gradient reaches the chosen
position, as the reference's custom VJP routes it. The 3-D pools and the
transposed 3-D convolution, ``spp``, ``unpool``, ``data_norm`` and the
channel, depth and temporal shuffles follow.

The detection family's ops (``polygon_box_transform``, ``psroi_pool``,
``prroi_pool``, ``deformable_psroi_pool``, ``collect_fpn_proposals``,
``sigmoid_focal_loss`` and ``retinanet_detection_output``) are dense
gathers over all RoIs at once, where the reference ``vmap``s over them.
"""

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.detection import _sort_desc, multiclass_nms
from paddle_tpu_torch.ops.nn import _pair, _triple


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



# ------------------------------------------------ grids, pools, convs

@register_op("affine_grid")
def affine_grid(theta, out_shape):
    """theta ``[N, 2, 3]`` -> the sampling grid ``[N, H, W, 2]`` in [-1,
    1] (align_corners=True; ref: ``vision.py:24``)."""
    _, _, H, W = out_shape
    xs = torch.linspace(-1.0, 1.0, W, device=theta.device)
    ys = torch.linspace(-1.0, 1.0, H, device=theta.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return torch.einsum("hwk,nck->nhwc", base.to(theta.dtype), theta)


def _bilinear_sample(x, ix, iy):
    """NCHW ``x`` sampled at float pixel coordinates ``ix``/``iy``
    ``[N, ...]`` -> ``[N, ..., C]``, zero padding (ref: ``vision.py:38``):
    four corners, each weighted ``(1 - |dx|)(1 - |dy|)`` and kept when it
    lies inside, border included."""
    N, C, H, W = x.shape
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    batch = torch.arange(N, device=x.device).reshape(
        (N,) + (1,) * (ix.ndim - 1))
    chans = torch.arange(C, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = 0.0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi = x0 + dx
        yi = y0 + dy
        w = (1 - torch.abs(ix - xi)) * (1 - torch.abs(iy - yi))
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(xi, 0, W - 1).long()
        yc = torch.clamp(yi, 0, H - 1).long()
        vals = x[batch[..., None], chans, yc[..., None], xc[..., None]]
        wv = (valid.to(w.dtype) * w)[..., None]
        out = out + torch.where(wv != 0, vals * wv, zero)
    return out


@register_op("grid_sampler")
def grid_sampler(x, grid):
    """Bilinear sample of NCHW x at grid ``[N, H, W, 2]`` (normalized,
    align_corners=True, zero padding; ref: ``vision.py:58``) -> NCHW."""
    _, _, H, W = x.shape
    gx = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    return _bilinear_sample(x, gx, gy).permute(0, 3, 1, 2)


@register_op("space_to_depth")
def space_to_depth(x, blocksize):
    """NCHW ``[N, C, H, W]`` -> ``[N, C b b, H / b, W / b]`` (ref:
    ``vision.py:69``)."""
    N, C, H, W = x.shape
    b = blocksize
    x = x.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(N, C * b * b, H // b, W // b)


@register_op("shuffle_channel")
def shuffle_channel(x, group):
    """ShuffleNet's channel shuffle (ref: ``vision.py:79``)."""
    N, C, H, W = x.shape
    return x.reshape(N, group, C // group, H, W).transpose(1, 2).reshape(
        N, C, H, W)


@register_op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25):
    """TSM's shift over ``[N T, C, H, W]`` (ref: ``vision.py:87``): the
    first ``C ratio`` channels from t - 1, the next from t + 1."""
    NT, C, H, W = x.shape
    N = NT // seg_num
    x = x.reshape(N, seg_num, C, H, W)
    c1 = int(C * shift_ratio)
    c2 = int(C * 2 * shift_ratio)
    pad = torch.zeros((N, 1, C, H, W), dtype=x.dtype, device=x.device)
    prev = torch.cat([pad, x[:, :-1]], 1)
    nxt = torch.cat([x[:, 1:], pad], 1)
    out = torch.cat([prev[:, :, :c1], nxt[:, :, c1:c2], x[:, :, c2:]], 2)
    return out.reshape(NT, C, H, W)


def _windows(x, ks, st, pads, value):
    """``x`` padded per side by ``pads`` with ``value``, cut into its
    windows: ``[..., *out, *ks]`` over the trailing ``len(ks)`` dims."""
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    xp = F.pad(x, flat, value=value)
    lead = x.ndim - len(ks)
    for i, (k, s) in enumerate(zip(ks, st)):
        xp = xp.unfold(lead + i, k, s)
    return xp


@register_op("pool3d")
def pool3d(x, pool_size, pool_type="max", pool_stride=1, pool_padding=0,
           ceil_mode=False, exclusive=True):
    """NCDHW max/avg pooling (ref: ``vision.py:104``); ``ceil_mode`` pads
    ``stride - 1`` more at the high side; ``exclusive`` averages over the
    window's unpadded entries."""
    ks, st, pd = _triple(pool_size), _triple(pool_stride), \
        _triple(pool_padding)
    pads = [(p, p + (s - 1 if ceil_mode else 0)) for p, s in zip(pd, st)]
    red = (-3, -2, -1)
    if pool_type == "max":
        return torch.amax(_windows(x, ks, st, pads, -float("inf")), red)
    s = _windows(x, ks, st, pads, 0.0).sum(red)
    if exclusive:
        cnt = _windows(torch.ones_like(x[:1, :1]), ks, st, pads, 0.0).sum(red)
    else:
        cnt = float(ks[0] * ks[1] * ks[2])
    return s / cnt


@register_op("conv3d_transpose")
def conv3d_transpose(x, weight, stride=1, padding=0, dilation=1, groups=1,
                     bias=None):
    """NCDHW transposed convolution, weight ``[C_in, C_out / groups, kd,
    kh, kw]`` (ref: ``vision.py:130``, the lhs-dilated convolution with
    the flipped kernel that ``conv_transpose3d`` computes)."""
    out = F.conv_transpose3d(x, weight, None, _triple(stride),
                             _triple(padding), 0, groups, _triple(dilation))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out


@register_op("max_pool2d_with_index")
def max_pool2d_with_index(x, pool_size, pool_stride=1, pool_padding=0):
    """``(pooled, flat argmax index into each image's H x W plane)`` (ref:
    ``vision.py:205``), as ``unpool`` consumes it; on a tie the lowest
    index. The pooled values are gathered at the index, so the gradient
    reaches the chosen position."""
    N, C, H, W = x.shape
    ks, st, pd = _pair(pool_size), _pair(pool_stride), _pair(pool_padding)
    pads = [(p, p) for p in pd]
    vals = _windows(x, ks, st, pads, -float("inf")).detach()
    plane = torch.arange(H * W, dtype=torch.float32,
                         device=x.device).reshape(1, 1, H, W)
    idx = _windows(plane, ks, st, pads, -1.0)
    vals = vals.flatten(-2)
    idx = idx.flatten(-2).expand(N, C, *vals.shape[2:])
    top = vals.amax(-1, keepdim=True)
    pick = torch.where(vals == top, idx, torch.full_like(idx, float(H * W)))
    best = pick.amin(-1).to(torch.int32)
    flat = x.reshape(N, C, H * W)
    got = torch.gather(flat, 2, torch.clamp(best, min=0).long().reshape(
        N, C, -1)).reshape(best.shape)
    neg = torch.full((), -float("inf"), dtype=x.dtype, device=x.device)
    return torch.where(best >= 0, got, neg), best


@register_op("unpool")
def unpool(x, indices, out_hw):
    """Max-unpool (ref: ``vision.py:221``): each pooled value added at its
    index of a zeros ``[N, C, H, W]``."""
    N, C, _, _ = x.shape
    H, W = out_hw
    idx = indices.reshape(N, C, -1).long()
    vals = x.reshape(N, C, -1)
    vals = torch.where(idx >= 0, vals, torch.zeros_like(vals))
    flat = torch.zeros((N, C, H * W), dtype=x.dtype, device=x.device)
    return flat.scatter_add(2, torch.clamp(idx, 0, H * W - 1), vals).reshape(
        N, C, H, W)


@register_op("spp")
def spp(x, pyramid_height=3, pool_type="max"):
    """Spatial pyramid pooling at 1, 2, 4 ... bins, flattened and
    concatenated (ref: ``vision.py:236``)."""
    from paddle_tpu_torch.ops.nn import adaptive_pool2d
    N = x.shape[0]
    return torch.cat([adaptive_pool2d(x, (2 ** lv, 2 ** lv),
                                      pool_type=pool_type).reshape(N, -1)
                      for lv in range(pyramid_height)], 1)


@register_op("data_norm")
def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4):
    """Normalization by accumulated batch statistics (ref:
    ``vision.py:250``): ``((x - means) * scales, means, scales)``."""
    means = batch_sum / batch_size
    scales = torch.sqrt(batch_size / torch.maximum(
        batch_square_sum, torch.full((), epsilon, dtype=batch_square_sum.dtype,
                                     device=batch_square_sum.device)))
    return (x - means) * scales, means, scales


@register_op("deformable_conv")
def deformable_conv(x, offset, weight, stride=1, padding=0, dilation=1,
                    deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1, and v2 with ``mask`` (ref:
    ``vision.py:271``): x ``[N, C, H, W]``; offset ``[N, 2 dg kh kw, Ho,
    Wo]`` (y, x interleaved a tap); weight ``[C_out, C_in / groups, kh,
    kw]``; mask ``[N, dg kh kw, Ho, Wo]``. Each tap bilinearly sampled
    (:func:`_bilinear_sample`), then one ``[N Ho Wo, kh kw C] x [kh kw C,
    C_out]`` product (one a group)."""
    N, C, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    Ho = (H + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
    Wo = (W + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
    dg = deformable_groups
    base_y = (torch.arange(Ho, device=x.device) * st[0] - pd[0])[:, None]
    base_x = (torch.arange(Wo, device=x.device) * st[1] - pd[1])[None, :]
    off = offset.reshape(N, dg, kh * kw, 2, Ho, Wo)
    cg = C // dg
    cols = []
    for t in range(kh * kw):
        ky, kx = divmod(t, kw)
        iy = base_y[None, None] + ky * dl[0] + off[:, :, t, 0]
        ix = base_x[None, None] + kx * dl[1] + off[:, :, t, 1]
        tap = []
        for g in range(dg):
            smp = _bilinear_sample(x[:, g * cg:(g + 1) * cg], ix[:, g],
                                   iy[:, g])
            if mask is not None:
                smp = smp * mask[:, g * kh * kw + t][..., None]
            tap.append(smp)
        cols.append(torch.cat(tap, -1))
    col = torch.stack(cols, 3).reshape(N, Ho, Wo, kh * kw * C)
    if groups == 1:
        out = col @ weight.permute(2, 3, 1, 0).reshape(kh * kw * C, Cout)
    else:
        cing, coutg = C // groups, Cout // groups
        colg = col.reshape(N, Ho, Wo, kh * kw, groups, cing)
        wg = weight.reshape(groups, coutg, cing, kh, kw)
        out = torch.cat([
            colg[..., g, :].reshape(N, Ho, Wo, kh * kw * cing)
            @ wg[g].permute(2, 3, 1, 0).reshape(kh * kw * cing, coutg)
            for g in range(groups)], -1)
    return out.permute(0, 3, 1, 2)
