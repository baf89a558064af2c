"""Detection heads (ref: ``paddle_tpu/nn/heads.py``): the SSD multi-box
head, loc/conf convolutions over several feature maps with their priors.
Its outputs are the reference's: (mbox_locs ``[B, N, 4]``, mbox_confs
``[B, N, C]``, prior boxes ``[N, 4]``, variances ``[N, 4]``), the priors
in pixels of the ``base_size`` image."""

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.nn.layers import Conv2D
from paddle_tpu_torch.ops.detection import expand_aspect_ratios, prior_box


def _num_priors(min_sizes, max_sizes, aspect_ratios, flip):
    ars = expand_aspect_ratios(aspect_ratios, flip)
    per_min = 1 + len([a for a in ars if abs(a - 1.0) > 1e-6])
    n = len(min_sizes) * per_min
    if max_sizes:
        n += len(min_sizes)
    return n


class MultiBoxHead(nn.Module):
    """SSD multi-box head (ref: ``nn/heads.py:27``). ``per_map_cfg``: one
    dict a feature map (``min_sizes``, ``max_sizes`` or None,
    ``aspect_ratios``); ``in_channels``: each map's channels;
    ``base_size``: the input image's side. The convolutions are
    xavier-initialised from ``gen`` and named as the reference's
    (``loc_convs.<i>``, ``conf_convs.<i>``), so the weight bridge carries
    them across. The priors depend only on the maps' shapes; they are
    built on the input's device at the first call for a shape and device,
    then reused."""

    def __init__(self, in_channels, num_classes, per_map_cfg, base_size,
                 kernel_size=3, flip=True, clip=False,
                 variance=(0.1, 0.1, 0.2, 0.2), steps=None, offset=0.5,
                 min_max_aspect_ratios_order=False, gen=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.cfgs = per_map_cfg
        self.base_size = base_size
        self.flip, self.clip = flip, clip
        self.variance = tuple(variance)
        self.steps = steps
        self.offset = offset
        self.mmaro = min_max_aspect_ratios_order
        pad = (kernel_size - 1) // 2
        self.priors_per_map = [
            _num_priors(cfg["min_sizes"], cfg.get("max_sizes"),
                        cfg["aspect_ratios"], flip) for cfg in per_map_cfg]
        self.loc_convs = nn.ModuleList(
            Conv2D(ci, p * 4, kernel_size, padding=pad,
                   weight_init=I.xavier(), gen=gen, dtype=dtype)
            for ci, p in zip(in_channels, self.priors_per_map))
        self.conf_convs = nn.ModuleList(
            Conv2D(ci, p * num_classes, kernel_size, padding=pad,
                   weight_init=I.xavier(), gen=gen, dtype=dtype)
            for ci, p in zip(in_channels, self.priors_per_map))
        self._priors = {}

    def priors(self, shapes, image_shape, device):
        """(boxes ``[N, 4]``, variances ``[N, 4]``) of feature maps of
        ``shapes`` ``[(h, w), ...]``, on ``device``."""
        key = (tuple(shapes), tuple(image_shape), str(device))
        if key not in self._priors:
            boxes, vars_ = [], []
            for i, (shape, cfg, p) in enumerate(zip(shapes, self.cfgs,
                                                    self.priors_per_map)):
                if self.steps:
                    # one scalar a map, or a (w, h) pair in the reference's
                    # order; prior_box takes (step_h, step_w)
                    st = self.steps[i]
                    st = ((st, st) if isinstance(st, (int, float))
                          else (st[1], st[0]))
                else:
                    st = (0.0, 0.0)
                pb, pv = prior_box(
                    shape, image_shape, cfg["min_sizes"],
                    cfg.get("max_sizes"), cfg["aspect_ratios"],
                    variance=self.variance, flip=self.flip, clip=self.clip,
                    steps=st, offset=self.offset,
                    min_max_aspect_ratios_order=self.mmaro, device=device)
                assert pb.shape[2] == p, (pb.shape, p)
                boxes.append(pb.reshape(-1, 4))
                vars_.append(pv.reshape(-1, 4))
            self._priors[key] = (torch.cat(boxes, 0), torch.cat(vars_, 0))
        return self._priors[key]

    def forward(self, inputs, image_shape=None):
        """inputs: NCHW feature maps. Returns (locs ``[B, N, 4]``, confs
        ``[B, N, C]``, boxes ``[N, 4]``, variances ``[N, 4]``)."""
        image_shape = image_shape or (self.base_size, self.base_size)
        locs, confs = [], []
        for x, lc, cc in zip(inputs, self.loc_convs, self.conf_convs):
            b = x.shape[0]
            locs.append(lc(x).permute(0, 2, 3, 1).reshape(b, -1, 4))
            confs.append(cc(x).permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes))
        boxes, vars_ = self.priors([tuple(x.shape[2:]) for x in inputs],
                                   image_shape, inputs[0].device)
        return torch.cat(locs, 1), torch.cat(confs, 1), boxes, vars_
