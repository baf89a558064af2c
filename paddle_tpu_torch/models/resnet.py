"""ResNet-18/34/50/101/152 — the port of ``paddle_tpu/models/resnet.py``,
the conv flagship that ``bench.py --model resnet50`` trains.

The reference computes channels-last by default (``data_format="NHWC"``)
with HWIO kernels and transposes an NCHW batch once at the stem; the port
keeps that storage (so ``paddle_tpu_torch/bridge.py`` copies weights
without transposing them) and computes NHWC as torch's ``channels_last``
memory format (``ops.nn.conv2d``). Convolutions are the library's (cuDNN
on the card), as the reference's are XLA's; batch norm is the
reference's formula in plain torch (``ops.nn.batch_norm``). No kernel of
the port runs on this path. Parameter names are the reference's
(``stem.conv.weight``, ``stages.0.0.conv1.bn.scale``); the running
statistics are buffers named as its ``state`` leaves
(``stages.0.0.conv1.bn.mean``).

The space-to-depth stem (the reference's ``resnet_s2d_stem`` flag, off
by default: ``PT_FLAGS_resnet_s2d_stem=1`` or :func:`configure`) runs the
7x7 stride-2 stem of an NHWC ImageNet model as the exact 4x4 stride-1
convolution over the 2x2 space-to-depth input (``_space_to_depth_nhwc``,
``_stem_s2d_weights``), the same logits by an index rewrite of the
kernel.
"""

import torch
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.settings import env_default
from paddle_tpu_torch.ops import activations as A
from paddle_tpu_torch.ops import nn as F


_SETTINGS = {"resnet_s2d_stem": env_default("resnet_s2d_stem", False)}


def configure(resnet_s2d_stem=None):
    """Turn the space-to-depth stem on or off (None leaves it); returns
    the settings."""
    if resnet_s2d_stem is not None:
        _SETTINGS["resnet_s2d_stem"] = bool(resnet_s2d_stem)
    return dict(_SETTINGS)


def _space_to_depth_nhwc(x, b=2):
    """``[N, H, W, C]`` -> ``[N, H / b, W / b, b b C]``, channel order
    (di, dj, c) (ref: ``resnet.py:20``)."""
    n, h, w, c = x.shape
    if h % b or w % b:
        raise ValueError(
            f"the s2d stem requires H and W divisible by {b}; got {h}x{w}. "
            "Use the default 7x7 stem for odd input sizes.")
    x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b, w // b, b * b * c)


def _stem_s2d_weights(w):
    """The 7x7/s2 stem kernel ``[7, 7, cin, cout]`` (HWIO) as the exact
    4x4/s1 kernel over space-to-depth(2) input, ``[4, 4, 4 cin, cout]``
    (ref: ``resnet.py:31``): the 7-tap window zero-padded on the top and
    left to 8 taps, which are s2d rows o-2 .. o+1, so padding (2, 1)."""
    k, _, cin, cout = w.shape
    assert k == 7, "s2d stem transform expects the 7x7 ImageNet stem"
    w8 = torch.nn.functional.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))
    ws = w8.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    return ws.reshape(4, 4, 4 * cin, cout)


class ConvBN(nn.Module):
    """A bias-free convolution (msra, padding ``(k - 1) // 2``) and a batch
    norm with ``act`` (ref: ``resnet.py:53``)."""

    def __init__(self, cin, cout, k, stride=1, act="relu", groups=1,
                 data_format="NCHW", gen=None):
        super().__init__()
        self.conv = pnn.Conv2D(cin, cout, k, stride=stride,
                               padding=(k - 1) // 2, groups=groups,
                               bias=False, weight_init=I.msra(), gen=gen,
                               data_format=data_format)
        self.bn = pnn.BatchNorm(cout, act=act, data_format=data_format)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, cout, stride=1, data_format="NCHW", gen=None):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 3, stride, data_format=data_format,
                            gen=gen)
        self.conv2 = ConvBN(cout, cout, 3, act=None, data_format=data_format,
                            gen=gen)
        self.short = None
        if stride != 1 or cin != cout:
            self.short = ConvBN(cin, cout, 1, stride, act=None,
                                data_format=data_format, gen=gen)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        sc = self.short(x) if self.short is not None else x
        return A.relu(out + sc)      # jnp.maximum(out + sc, 0): resnet.py:77


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1, data_format="NCHW", gen=None):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = ConvBN(cin, width, 1, data_format=data_format, gen=gen)
        self.conv2 = ConvBN(width, width, 3, stride, data_format=data_format,
                            gen=gen)
        self.conv3 = ConvBN(width, cout, 1, act=None, data_format=data_format,
                            gen=gen)
        self.short = None
        if stride != 1 or cin != cout:
            self.short = ConvBN(cin, cout, 1, stride, act=None,
                                data_format=data_format, gen=gen)

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        sc = self.short(x) if self.short is not None else x
        return A.relu(out + sc)      # jnp.maximum(out + sc, 0): resnet.py:97


_CONFIGS = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (Bottleneck, [3, 4, 6, 3]),
    101: (Bottleneck, [3, 4, 23, 3]),
    152: (Bottleneck, [3, 8, 36, 3]),
}


class ResNet(nn.Module):
    """ref: ``resnet.py:113``. ``small_input`` takes the CIFAR stem (3x3,
    no max pool); ``data_format`` is the compute layout (NHWC by default),
    ``input_layout`` the incoming batch's (NCHW by default: transposed
    once at the stem). Weights are drawn from ``seed`` on the CPU and
    moved to ``device``, which defaults to the card and raises when there
    is none. ``forward(x)`` gives the logits; the mode (``train()``, the
    default, or ``eval()``) picks batch or running statistics."""

    def __init__(self, depth=50, num_classes=1000, small_input=False,
                 data_format="NHWC", input_layout="NCHW", device="cuda",
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        block, layers = _CONFIGS[depth]
        self.small_input = small_input
        self.data_format = data_format
        self.input_layout = input_layout
        df = data_format
        if small_input:
            self.stem = ConvBN(3, 64, 3, data_format=df, gen=gen)
        else:
            self.stem = ConvBN(3, 64, 7, stride=2, data_format=df, gen=gen)
        stages = []
        cin = 64
        for i, n in enumerate(layers):
            width = 64 * (2 ** i)
            blocks = []
            for j in range(n):
                stride = 2 if (j == 0 and i > 0) else 1
                blocks.append(block(cin, width, stride, data_format=df,
                                    gen=gen))
                cin = width * block.expansion
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)
        self.fc = pnn.Linear(cin, num_classes, gen=gen,
                             weight_init=I.uniform(-0.01, 0.01))
        self.to(dev)

    @property
    def device(self):
        return next(self.parameters()).device

    def forward(self, x):
        if self.data_format == "NHWC" and self.input_layout == "NCHW":
            x = x.permute(0, 2, 3, 1).contiguous()    # once, at the stem
        if (not self.small_input and self.data_format == "NHWC"
                and _SETTINGS["resnet_s2d_stem"]):
            w = _stem_s2d_weights(self.stem.conv.weight)
            x = F.conv2d(_space_to_depth_nhwc(x), w.to(x.dtype),
                         padding=((2, 1), (2, 1)), data_format="NHWC")
            x = self.stem.bn(x)
        else:
            x = self.stem(x)
        if not self.small_input:
            x = F.pool2d(x, 3, "max", 2, padding=1,
                         data_format=self.data_format)
        for stage in self.stages:
            x = stage(x)
        x = F.pool2d(x, pool_type="avg", global_pooling=True,
                     data_format=self.data_format)
        return self.fc(x.reshape(x.shape[0], -1))


def resnet50(num_classes=1000, **kw):
    return ResNet(50, num_classes, **kw)


def resnet18(num_classes=1000, **kw):
    return ResNet(18, num_classes, **kw)
