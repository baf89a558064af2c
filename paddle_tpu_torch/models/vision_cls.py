"""VGG and SE-ResNeXt image classifiers — the port of
``paddle_tpu/models/vision_cls.py``: the book's ``vgg16_bn_drop`` and the
reference's SE-ResNeXt-50 (grouped 3x3 bottlenecks with a
squeeze-and-excitation gate).

Both compute NCHW with OIHW kernels, as the reference builds them (its
``ConvBN`` default), and pool globally with a mean over the spatial axes.
Weights are drawn from ``seed`` on the CPU and moved to ``device`` (the
card by default; raises without one); VGG's dropout masks come from
``dropout_gen``, a generator on ``device`` seeded with ``seed``.
"""

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.resnet import ConvBN
from paddle_tpu_torch.ops import activations as A
from paddle_tpu_torch.ops import nn as F


class VGG(nn.Module):
    """Configurable VGG with batch norm (ref: ``vision_cls.py:17``)."""

    CFGS = {
        11: (1, 1, 2, 2, 2),
        13: (2, 2, 2, 2, 2),
        16: (2, 2, 3, 3, 3),
        19: (2, 2, 4, 4, 4),
    }

    def __init__(self, depth=16, num_classes=10, in_channels=3, dropout=0.5,
                 device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dropout_gen = torch.Generator(device=dev).manual_seed(seed)
        widths = (64, 128, 256, 512, 512)
        blocks = []
        cin = in_channels
        for reps, w in zip(self.CFGS[depth], widths):
            for _ in range(reps):
                blocks.append(ConvBN(cin, w, 3, gen=gen))
                cin = w
        self.blocks = nn.ModuleList(blocks)
        self.stage_reps = self.CFGS[depth]
        self.drop = pnn.Dropout(dropout, gen=self.dropout_gen)
        self.fc1 = pnn.Linear(512, 512, act="relu", gen=gen)
        self.fc2 = pnn.Linear(512, 512, act="relu", gen=gen)
        self.head = pnn.Linear(512, num_classes, gen=gen)
        self.to(dev)

    @property
    def device(self):
        return next(self.parameters()).device

    def forward(self, x):
        i = 0
        for reps in self.stage_reps:
            for _ in range(reps):
                x = self.blocks[i](x)
                i += 1
            x = F.pool2d(x, 2, pool_type="max", stride=2)
        x = torch.mean(x, dim=(2, 3))
        x = self.drop(self.fc1(x))
        x = self.drop(self.fc2(x))
        return self.head(x)


def vgg16(num_classes=10, **kw):
    return VGG(16, num_classes, **kw)


class SEBlock(nn.Module):
    """Squeeze-and-excitation channel gate (ref: ``vision_cls.py:61``)."""

    def __init__(self, channels, reduction=16, gen=None):
        super().__init__()
        mid = max(channels // reduction, 4)
        self.fc1 = pnn.Linear(channels, mid, act="relu", gen=gen)
        self.fc2 = pnn.Linear(mid, channels, act="sigmoid", gen=gen)

    def forward(self, x):
        s = self.fc2(self.fc1(torch.mean(x, dim=(2, 3))))
        return x * s[:, :, None, None]


class SEBottleneck(nn.Module):
    """ref: ``vision_cls.py:77`` — 1x1, grouped 3x3 (``cardinality``
    groups), 1x1, the SE gate, and the shortcut."""

    expansion = 2

    def __init__(self, cin, width, cardinality=32, stride=1, reduction=16,
                 gen=None):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = ConvBN(cin, width, 1, gen=gen)
        self.conv2 = ConvBN(width, width, 3, stride, groups=cardinality,
                            gen=gen)
        self.conv3 = ConvBN(width, cout, 1, act=None, gen=gen)
        self.se = SEBlock(cout, reduction, gen=gen)
        self.short = None
        if stride != 1 or cin != cout:
            self.short = ConvBN(cin, cout, 1, stride, act=None, gen=gen)

    def forward(self, x):
        out = self.se(self.conv3(self.conv2(self.conv1(x))))
        sc = self.short(x) if self.short is not None else x
        return A.relu(out + sc)  # jnp.maximum(out + sc, 0): vision_cls.py:93


class SEResNeXt(nn.Module):
    """SE-ResNeXt-50 (32x4d family), the reference's parallel-executor
    regression model (ref: ``vision_cls.py:96``)."""

    def __init__(self, layers=(3, 4, 6, 3), cardinality=32, num_classes=1000,
                 in_channels=3, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.stem = ConvBN(in_channels, 64, 7, stride=2, gen=gen)
        widths = (128, 256, 512, 1024)
        blocks = []
        cin = 64
        for si, (reps, w) in enumerate(zip(layers, widths)):
            for bi in range(reps):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(SEBottleneck(cin, w, cardinality, stride,
                                           gen=gen))
                cin = w * SEBottleneck.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = pnn.Linear(cin, num_classes, gen=gen,
                               weight_init=I.uniform(-0.001, 0.001))
        self.to(dev)

    @property
    def device(self):
        return next(self.parameters()).device

    def forward(self, x):
        x = self.stem(x)
        x = F.pool2d(x, 3, pool_type="max", stride=2, padding=1)
        for b in self.blocks:
            x = b(x)
        return self.head(torch.mean(x, dim=(2, 3)))


def se_resnext50(num_classes=1000, **kw):
    return SEResNeXt((3, 4, 6, 3), num_classes=num_classes, **kw)
