"""The MNIST book models and ``fit_a_line`` — the port of
``paddle_tpu/models/mnist.py``, the reference's minimal end-to-end
fixtures. Weights are drawn from ``seed`` on the CPU and moved to
``device`` (the card by default; raises without one)."""

import torch
from torch import nn

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops import nn as F


class SoftmaxRegression(nn.Module):
    """ref: ``mnist.py:12`` — one fc over the flattened image."""

    def __init__(self, num_classes=10, in_dim=784, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.fc = pnn.Linear(in_dim, num_classes, gen=gen)
        self.to(dev)

    def forward(self, x):
        return self.fc(x.reshape(x.shape[0], -1))


class MLP(nn.Module):
    """ref: ``mnist.py:21`` (multilayer_perceptron)."""

    def __init__(self, num_classes=10, in_dim=784, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.fc1 = pnn.Linear(in_dim, 128, act="relu", gen=gen)
        self.fc2 = pnn.Linear(128, 64, act="relu", gen=gen)
        self.fc3 = pnn.Linear(64, num_classes, gen=gen)
        self.to(dev)

    def forward(self, x):
        return self.fc3(self.fc2(self.fc1(x.reshape(x.shape[0], -1))))


class ConvNet(nn.Module):
    """ref: ``mnist.py:34`` (convolutional_neural_network /
    simple_img_conv_pool): two 5x5 convolutions with relu, each followed by
    a 2x2 max pool, and an fc; NCHW ``[B, 1, 28, 28]``."""

    def __init__(self, num_classes=10, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = pnn.Conv2D(1, 20, 5, act="relu", gen=gen)
        self.conv2 = pnn.Conv2D(20, 50, 5, act="relu", gen=gen)
        self.fc = pnn.Linear(50 * 4 * 4, num_classes, gen=gen)
        self.to(dev)

    def forward(self, x):
        x = F.pool2d(self.conv1(x), 2, "max", 2)
        x = F.pool2d(self.conv2(x), 2, "max", 2)
        return self.fc(x.reshape(x.shape[0], -1))


class LinearRegression(nn.Module):
    """ref: ``mnist.py:50`` (the fit_a_line book model): one fc to a
    scalar per row."""

    def __init__(self, in_features=13, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.fc = pnn.Linear(in_features, 1, gen=gen)
        self.to(dev)

    def forward(self, x):
        return self.fc(x)[..., 0]
