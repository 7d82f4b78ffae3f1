"""CIFAR ResNet-18/34/50/101/152 (draco_tpu/models/resnet.py).

3×3 stem (no max-pool), stage widths 64/128/256/512, BasicBlock for 18/34
and Bottleneck (expansion 4) for 50/101/152, 4×4 average pool before the
classifier.

Submodules carry the reference's Flax names (``Conv_0``, ``BatchNorm_1``,
``BasicBlock_3``, ``Dense_0``) so a parameter's path in the port maps to its
path in the reference one to one (``params.py``). Inputs are NHWC, as in the
reference; the convolutions run in NCHW inside. The convolutions, the
residual sums and the pool run in the compute dtype, BatchNorm in float32
and the classifier in float32 (``models/layers.py``).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from draco_tpu_torch.models.layers import (  # noqa: F401  (re-exported)
    BatchNorm,
    Conv,
    classify,
    Dense,
    init_params,
    init_stats,
    name_norms,
    nhwc_flatten,
    to_compute,
)


def _conv(cin, cout, k, stride=1, dt=None):
    return Conv(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                compute_dtype=dt)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dt=None):
        super().__init__()
        self.Conv_0 = _conv(in_planes, planes, 3, stride, dt)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = _conv(planes, planes, 3, dt=dt)
        self.BatchNorm_1 = BatchNorm(planes)
        self.shortcut = stride != 1 or in_planes != planes
        if self.shortcut:
            self.Conv_2 = _conv(in_planes, planes, 1, stride, dt)
            self.BatchNorm_2 = BatchNorm(planes)

    def forward(self, x, stats, new_stats):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x), stats, new_stats))
        out = self.BatchNorm_1(self.Conv_1(out), stats, new_stats)
        if self.shortcut:
            x = self.BatchNorm_2(self.Conv_2(x), stats, new_stats)
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dt=None):
        super().__init__()
        wide = planes * self.expansion
        self.Conv_0 = _conv(in_planes, planes, 1, dt=dt)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = _conv(planes, planes, 3, stride, dt)
        self.BatchNorm_1 = BatchNorm(planes)
        self.Conv_2 = _conv(planes, wide, 1, dt=dt)
        self.BatchNorm_2 = BatchNorm(wide)
        self.shortcut = stride != 1 or in_planes != wide
        if self.shortcut:
            self.Conv_3 = _conv(in_planes, wide, 1, stride, dt)
            self.BatchNorm_3 = BatchNorm(wide)

    def forward(self, x, stats, new_stats):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x), stats, new_stats))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out), stats, new_stats))
        out = self.BatchNorm_2(self.Conv_2(out), stats, new_stats)
        if self.shortcut:
            x = self.BatchNorm_3(self.Conv_3(x), stats, new_stats)
        return F.relu(out + x)


class ResNet(nn.Module):
    dropout_features = ()  # no dropout

    def __init__(self, block, num_blocks, num_classes: int = 10,
                 in_channels: int = 3, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = _conv(in_channels, 64, 3, dt=dtype)
        self.BatchNorm_0 = BatchNorm(64)
        names = []
        in_planes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     num_blocks)):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"{block.__name__}_{len(names)}"
                setattr(self, name, block(in_planes, planes, stride, dtype))
                names.append(name)
                in_planes = planes * block.expansion
        self.block_names = tuple(names)
        self.Dense_0 = Dense(in_planes, num_classes)
        name_norms(self)

    def forward(self, x, stats: dict, dropout=None, train: bool = True):
        """x: (B, H, W, C) NHWC -> (logits (B, classes), new_stats);
        ``train=False``: BatchNorm on the running statistics, and no new
        ones."""
        new_stats = {} if train else None
        x = to_compute(x, self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), stats, new_stats))
        for name in self.block_names:
            x = getattr(self, name)(x, stats, new_stats)
        x = F.avg_pool2d(x, 4, 4)
        return classify(self.Dense_0, nhwc_flatten(x)), new_stats or {}


def ResNet18(num_classes: int = 10, in_channels: int = 3,
             dtype=None):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, in_channels, dtype)


def ResNet34(num_classes: int = 10, in_channels: int = 3,
             dtype=None):
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, in_channels, dtype)


def ResNet50(num_classes: int = 10, in_channels: int = 3,
             dtype=None):
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, in_channels, dtype)


def ResNet101(num_classes: int = 10, in_channels: int = 3,
             dtype=None):
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, in_channels, dtype)


def ResNet152(num_classes: int = 10, in_channels: int = 3,
             dtype=None):
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, in_channels, dtype)
