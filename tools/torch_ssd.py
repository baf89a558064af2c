"""SSD detection training on synthetic data through the PyTorch port:
``examples/train_ssd.py``'s TinySSD (a two-conv backbone, one extra map,
``MultiBoxHead`` over the 32- and 64-channel maps, 4 priors a cell),
``ssd_loss`` matching over a batch of images, Momentum(0.01, 0.9) on one
fixed batch, then ``detection_output`` (decode + NMS) on image 0.

    python3 tools/torch_ssd.py [--steps 20] [--batch 4] [--tiny]
                               [--device cuda|cpu]

At base 300 (the default) the backbone's maps are 75 x 75 and 38 x 38:
28,276 priors; ``--tiny`` is base 64 (1,280 priors). ``chip_smoke.py``'s
ssd phase and ``tests/test_torch_ssd.py`` build the model from here.

The example divides the head's priors by the image side
(``examples/train_ssd.py:78``, ``:105``), but ``prior_box`` has already
normalized them (``paddle_tpu/ops/detection.py:168``), so the example
trains and decodes against priors 1/base of their size, in the image's
top-left corner: almost no ground-truth box overlaps one, so almost no
prior is matched and the loss is the mined negatives' classification
loss. The port keeps the example's arithmetic (``prior_scale`` = base) so
that it computes what the example computes; ``prior_scale=1``
(:data:`matched_loss_fn`) trains against the priors as the head returns
them, where matching, hard-negative mining and the box regression all
take part.
"""

import argparse
import functools
import os
import sys

import numpy as np
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.core.device import resolve_device  # noqa: E402
from paddle_tpu_torch.nn import Conv2D, MultiBoxHead  # noqa: E402
from paddle_tpu_torch.ops import detection as D  # noqa: E402

NUM_CLASSES = 4          # background + 3
GT_BOXES = 3             # ground-truth boxes an image


class TinySSD(nn.Module):
    """``examples/train_ssd.py:34``'s model at input side ``base``, its
    parameters named as the reference's tree (``backbone.0.weight``,
    ``head.loc_convs.1.bias`` ...), drawn from ``seed`` on the CPU and
    moved to ``device``."""

    def __init__(self, base=300, num_classes=NUM_CLASSES, device="cuda",
                 seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.base = base
        self.backbone = nn.Sequential(
            Conv2D(3, 16, 3, stride=2, padding=1, act="relu", gen=gen),
            Conv2D(16, 32, 3, stride=2, padding=1, act="relu", gen=gen))
        self.extra = Conv2D(32, 64, 3, stride=2, padding=1, act="relu",
                            gen=gen)
        self.head = MultiBoxHead(
            [32, 64], num_classes,
            per_map_cfg=[
                {"min_sizes": [base * 0.2], "max_sizes": [base * 0.4],
                 "aspect_ratios": [2.0]},
                {"min_sizes": [base * 0.4], "max_sizes": [base * 0.8],
                 "aspect_ratios": [2.0]},
            ],
            base_size=base, gen=gen)
        self.to(device)

    def forward(self, images):
        f1 = self.backbone(images)
        return self.head([f1, self.extra(f1)])


def ssd_batch(rs, batch, base, num_classes=NUM_CLASSES, gt=GT_BOXES):
    """The example's fixed batch, drawn from ``rs`` in its order: f32
    images ``[B, 3, base, base]`` uniform in [0, 1), ``gt`` normalized
    0.3 x 0.3 boxes an image and their labels in [1, num_classes)."""
    images = rs.rand(batch, 3, base, base).astype(np.float32)
    x1 = rs.uniform(0, 0.6, (batch, gt, 1))
    y1 = rs.uniform(0, 0.6, (batch, gt, 1))
    boxes = np.concatenate([x1, y1, x1 + 0.3, y1 + 0.3], -1)
    labels = rs.randint(1, num_classes, (batch, gt))
    return (torch.from_numpy(images),
            torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(labels))


def ssd_loss_fn(model, images, gt, labels, prior_scale=None):
    """The example's loss: the mean over images of ``ssd_loss`` against
    the head's priors divided by ``prior_scale`` (the image side, as the
    example divides them, unless given)."""
    locs, confs, boxes, _ = model(images)
    scale = model.base if prior_scale is None else prior_scale
    return D.ssd_loss(locs, confs, gt, labels, boxes / scale).mean()


#: the loss against the priors as the head returns them
matched_loss_fn = functools.partial(ssd_loss_fn, prior_scale=1.0)


def matched_priors(model, images, gt, prior_scale=None):
    """The priors ``ssd_loss``'s matching binds to a ground-truth box, per
    image (``[B]``), against the priors divided by ``prior_scale`` (the
    image side unless given)."""
    scale = model.base if prior_scale is None else prior_scale
    with torch.no_grad():
        boxes = model(images)[2] / scale
        valid = (gt[..., 2] > gt[..., 0]) & (gt[..., 3] > gt[..., 1])
        sim = torch.where(valid[..., None], D.iou_similarity(gt, boxes),
                          -1.0)
        midx, _ = D.bipartite_match(sim, "per_prediction", 0.5)
        return (midx >= 0).sum(-1)


def detect(model, images, index=0, keep_top_k=10, prior_scale=None):
    """The example's inference: ``detection_output`` of image ``index``
    (softmax scores, score 0.01, NMS 0.45; priors divided as in
    :func:`ssd_loss_fn`) -> (out ``[keep_top_k, 6]``, count)."""
    scale = model.base if prior_scale is None else prior_scale
    with torch.no_grad():
        locs, confs, boxes, vars_ = model(images)
        return D.detection_output(
            locs[index], torch.softmax(confs[index], -1), boxes / scale,
            vars_, score_threshold=0.01, nms_threshold=0.45,
            keep_top_k=keep_top_k)


def main():
    from paddle_tpu_torch.optimizer import Momentum
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    base = 64 if args.tiny else 300
    model = TinySSD(base, device=args.device)
    opt = Momentum(model.parameters(), 0.01, 0.9)
    dev = next(model.parameters()).device
    data = [t.to(dev) for t in ssd_batch(np.random.RandomState(0),
                                         args.batch, base)]
    print(f"matched priors an image: "
          f"{matched_priors(model, data[0], data[1]).tolist()}")
    first = loss = None
    for i in range(args.steps):
        loss = float(opt.minimize(model, ssd_loss_fn, *data))
        first = loss if first is None else first
        if (i + 1) % 5 == 0 or i == 0:
            print(f"step {i + 1} loss {loss:.4f}")
    print(f"loss {first:.4f} -> {loss:.4f}")
    assert loss < first, "loss did not decrease"
    out, count = detect(model, data[0])
    print(f"detection_output: {int(count)} kept, shape "
          f"{tuple(out.shape)}")


if __name__ == "__main__":
    main()
