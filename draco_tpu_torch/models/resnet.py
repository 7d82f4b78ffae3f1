"""CIFAR ResNet-18/34/50/101/152 (draco_tpu/models/resnet.py).

3×3 stem (no max-pool), stage widths 64/128/256/512, BasicBlock for 18/34
and Bottleneck (expansion 4) for 50/101/152, 4×4 average pool before the
classifier.

Submodules carry the reference's Flax names (``Conv_0``, ``BatchNorm_1``,
``BasicBlock_3``, ``Dense_0``) so a parameter's path in the port maps to its
path in the reference one to one (``params.py``). Inputs are NHWC, as in the
reference; the convolutions run in NCHW inside.

BatchNorm is functional in its running statistics: ``forward(x, stats)``
returns ``(logits, new_stats)``, with ``stats`` a flat dict keyed
``"<path>/mean"`` / ``"<path>/var"``. That lets ``torch.func.vmap`` carry
one set of statistics per worker lane (they are never aggregated), and it
gives the reference's semantics exactly: Flax's ``momentum=0.9`` (torch's
0.1) and a running variance updated with the *biased* batch variance,
where ``nn.BatchNorm2d`` would use the unbiased one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # Flax convention: new = m·old + (1-m)·batch
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))  # Flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        self.path = ""  # set by the owning ResNet: its Flax path

    def forward(self, x, stats: dict, new_stats: dict):
        """Training-mode BN on NCHW ``x`` with batch statistics; writes the
        updated running statistics into ``new_stats``."""
        dims = (0, 2, 3)
        mean = x.mean(dim=dims)
        # Flax's fast variance: E[x²] − E[x]², clipped at 0
        var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
        y = y + self.bias[None, :, None, None]
        key = self.path
        new_stats[key + "/mean"] = (BN_MOMENTUM * stats[key + "/mean"]
                                    + (1.0 - BN_MOMENTUM) * mean.detach())
        new_stats[key + "/var"] = (BN_MOMENTUM * stats[key + "/var"]
                                   + (1.0 - BN_MOMENTUM) * var.detach())
        return y


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = _conv(in_planes, planes, 3, stride)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = _conv(planes, planes, 3)
        self.BatchNorm_1 = BatchNorm(planes)
        self.shortcut = stride != 1 or in_planes != planes
        if self.shortcut:
            self.Conv_2 = _conv(in_planes, planes, 1, stride)
            self.BatchNorm_2 = BatchNorm(planes)

    def forward(self, x, stats, new_stats):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x), stats, new_stats))
        out = self.BatchNorm_1(self.Conv_1(out), stats, new_stats)
        if self.shortcut:
            x = self.BatchNorm_2(self.Conv_2(x), stats, new_stats)
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        wide = planes * self.expansion
        self.Conv_0 = _conv(in_planes, planes, 1)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = _conv(planes, planes, 3, stride)
        self.BatchNorm_1 = BatchNorm(planes)
        self.Conv_2 = _conv(planes, wide, 1)
        self.BatchNorm_2 = BatchNorm(wide)
        self.shortcut = stride != 1 or in_planes != wide
        if self.shortcut:
            self.Conv_3 = _conv(in_planes, wide, 1, stride)
            self.BatchNorm_3 = BatchNorm(wide)

    def forward(self, x, stats, new_stats):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x), stats, new_stats))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out), stats, new_stats))
        out = self.BatchNorm_2(self.Conv_2(out), stats, new_stats)
        if self.shortcut:
            x = self.BatchNorm_3(self.Conv_3(x), stats, new_stats)
        return F.relu(out + x)


class ResNet(nn.Module):
    def __init__(self, block, num_blocks, num_classes: int = 10,
                 in_channels: int = 3):
        super().__init__()
        self.Conv_0 = _conv(in_channels, 64, 3)
        self.BatchNorm_0 = BatchNorm(64)
        names = []
        in_planes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     num_blocks)):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"{block.__name__}_{len(names)}"
                setattr(self, name, block(in_planes, planes, stride))
                names.append(name)
                in_planes = planes * block.expansion
        self.block_names = tuple(names)
        self.Dense_0 = nn.Linear(in_planes, num_classes)
        for name, mod in self.named_modules():
            if isinstance(mod, BatchNorm):
                mod.path = name.replace(".", "/")

    def forward(self, x, stats: dict):
        """x: (B, H, W, C) NHWC -> (logits (B, classes), new_stats). The
        port computes in f32 throughout, so the reference's f32 classifier
        needs no cast; the model runs in whatever dtype its weights have."""
        new_stats = {}
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), stats, new_stats))
        for name in self.block_names:
            x = getattr(self, name)(x, stats, new_stats)
        x = F.avg_pool2d(x, 4, 4)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return self.Dense_0(x), new_stats


def ResNet18(num_classes: int = 10, in_channels: int = 3):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, in_channels)


def ResNet34(num_classes: int = 10, in_channels: int = 3):
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, in_channels)


def ResNet50(num_classes: int = 10, in_channels: int = 3):
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, in_channels)


def ResNet101(num_classes: int = 10, in_channels: int = 3):
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, in_channels)


def ResNet152(num_classes: int = 10, in_channels: int = 3):
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, in_channels)


def init_stats(model: nn.Module) -> dict:
    """Fresh running statistics: mean 0, var 1 per BN feature."""
    stats = {}
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            f = mod.weight.shape[0]
            stats[mod.path + "/mean"] = torch.zeros(f)
            stats[mod.path + "/var"] = torch.ones(f)
    return stats


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialisers from a seeded generator: LeCun-normal
    (truncated at ±2σ, variance 1/fan_in) kernels, zero biases, unit BN
    scale. Same distributions as the reference, other numbers."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            # std of the truncated normal on [-2, 2] is 0.87962566 of the
            # untruncated one; Flax rescales so the variance is 1/fan_in
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
