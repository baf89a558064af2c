"""Instance-mask target ops for Mask R-CNN training (ref:
``paddle_tpu/ops/mask.py``): polygon rasterization and mask labels.

Polygons are ragged host data, so these are numpy on the host, as in the
reference (and as the reference's own CPU-only kernel is); the dense
``[R, M, M]`` targets they produce feed the mask head on the device. The
rasterizer counts even-odd crossings at pixel centers.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op


@register_op("poly2mask")
def poly2mask(poly_xy, h, w):
    """Rasterize one polygon (flat ``[x0, y0, x1, y1, ...]``) into a uint8
    ``[h, w]`` mask, even-odd rule at pixel centers (ref: ``:22``)."""
    pts = np.asarray(poly_xy, np.float64).reshape(-1, 2)
    enforce(len(pts) >= 3, "polygon needs >= 3 points")
    ys = np.arange(h) + 0.5
    xs = np.arange(w) + 0.5
    x0 = pts[:, 0]
    y0 = pts[:, 1]
    x1 = np.roll(x0, -1)
    y1 = np.roll(y0, -1)
    mask = np.zeros((h, w), np.uint8)
    for row, yc in enumerate(ys):
        cross = (y0 <= yc) != (y1 <= yc)     # edges crossing this scanline
        if not cross.any():
            continue
        xi = x0[cross] + (yc - y0[cross]) * (x1[cross] - x0[cross]) \
            / (y1[cross] - y0[cross])
        mask[row] = (xi[None, :] <= xs[:, None]).sum(axis=1) % 2 == 1
    return mask


@register_op("polys_to_mask_wrt_box")
def polys_to_mask_wrt_box(polygons, box, resolution):
    """Rasterize a gt's polygon parts into an M x M grid over ``box``, the
    union of the parts (ref: ``:48``)."""
    x0, y0, x1, y1 = [float(v) for v in box]
    w = max(x1 - x0, 1.0)
    h = max(y1 - y0, 1.0)
    out = np.zeros((resolution, resolution), np.uint8)
    for part in polygons:
        p = np.asarray(part, np.float64).reshape(-1, 2).copy()
        p[:, 0] = (p[:, 0] - x0) * resolution / w
        p[:, 1] = (p[:, 1] - y0) * resolution / h
        out |= poly2mask(p.reshape(-1), resolution, resolution)
    return out


@register_op("generate_mask_labels")
def generate_mask_labels(rois, labels, gt_boxes, gt_polys, resolution=14):
    """Mask targets of the sampled fg RoIs (ref: ``:65``). rois ``[R, 4]``;
    labels ``[R]`` (``generate_proposal_labels``' labels: class for fg, 0
    bg, -1 ignored); gt_boxes ``[G, 4]``; gt_polys: G lists of polygon
    parts. Returns float32 ``[R, resolution, resolution]``: the mask of
    each fg RoI's best-overlapping gt, -1 (ignore) elsewhere."""
    from paddle_tpu_torch.ops.detection import iou_similarity
    rois = _host(rois).astype(np.float64)
    labels = _host(labels).astype(int)
    gtb = _host(gt_boxes).astype(np.float64)
    R = rois.shape[0]
    out = np.full((R, resolution, resolution), -1.0, np.float32)
    # the label sampler's +1 IoU convention, so that the mask comes from
    # the gt whose class labeled the roi
    iou = iou_similarity(torch.from_numpy(rois.astype(np.float32)),
                         torch.from_numpy(gtb.astype(np.float32)),
                         box_normalized=False).numpy()         # [R, G]
    for r in range(R):
        if labels[r] <= 0:
            continue
        g = int(np.argmax(iou[r]))
        if iou[r, g] <= 0:
            continue  # label/gt mismatch from the caller: keep -1 ignore
        out[r] = polys_to_mask_wrt_box(gt_polys[g], rois[r],
                                       resolution).astype(np.float32)
    return out


def _host(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
