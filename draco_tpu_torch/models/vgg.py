"""CIFAR VGG-11/13/16/19 with optional BatchNorm (draco_tpu/models/vgg.py).

Feature configs A/B/D/E of 3×3 convolutions (with bias) and 2×2
max-pools; classifier dropout → 512 → relu → dropout → 512 → relu → 10.
Submodules carry the reference's Flax names (``Conv_0`` … ``Conv_15``,
``BatchNorm_i``, ``Dense_0..2``), so ``params.layout`` sorts them as
``jax.tree.leaves`` does (``Conv_10`` before ``Conv_2``).

Dropout takes its two (B, 512) keep-masks as the ``dropout`` input, one
(2, B, 512) bool tensor: the reference folds the dropout key from (step,
batch row), so every worker that computes batch k drops the same units
and the codes stay exactly decodable; the port draws the masks on the
host from the same (seed + 3, step, row) discipline
(``training/step.py``).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from draco_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    classify,
    dropout,
    name_norms,
    nhwc_flatten,
    to_compute,
)

_CFG = {
    "A": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "B": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"),
    "D": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"),
    "E": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    dropout_features = (512, 512)  # the two classifier dropouts' widths

    def __init__(self, cfg, batch_norm: bool = False, num_classes: int = 10,
                 in_channels: int = 3, dtype=None):
        super().__init__()
        self.dtype, self.batch_norm = dtype, batch_norm
        self.plan = []  # ("conv", i) | ("pool",)
        cin, i = in_channels, 0
        for v in cfg:
            if v == "M":
                self.plan.append(("pool",))
                continue
            setattr(self, f"Conv_{i}", Conv(cin, v, 3, padding=1,
                                            compute_dtype=dtype))
            if batch_norm:
                setattr(self, f"BatchNorm_{i}", BatchNorm(v))
            self.plan.append(("conv", i))
            cin, i = v, i + 1
        self.Dense_0 = Dense(512, 512, compute_dtype=dtype)
        self.Dense_1 = Dense(512, 512, compute_dtype=dtype)
        self.Dense_2 = Dense(512, num_classes)
        name_norms(self)

    def forward(self, x, stats: dict, dropout_masks, train: bool = True):
        """x: (B, H, W, C) NHWC, ``dropout_masks`` (2, B, 512) bool keep
        masks -> (logits, new_stats); ``train=False``: no dropout (masks
        unread), BatchNorm on the running statistics."""
        new_stats = {} if train else None
        x = to_compute(x, self.dtype).permute(0, 3, 1, 2)
        for op in self.plan:
            if op[0] == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"Conv_{op[1]}")(x)
            if self.batch_norm:
                x = getattr(self, f"BatchNorm_{op[1]}")(x, stats, new_stats)
            x = F.relu(x)
        x = nhwc_flatten(x)
        if train:
            x = dropout(x, dropout_masks[0])
        x = F.relu(self.Dense_0(x))
        if train:
            x = dropout(x, dropout_masks[1])
        x = F.relu(self.Dense_1(x))
        return classify(self.Dense_2, x), new_stats or {}


def _vgg(cfg: str, bn: bool):
    def make(num_classes: int = 10, in_channels: int = 3, dtype=None):
        return VGG(_CFG[cfg], bn, num_classes, in_channels, dtype)
    return make


VGG11, VGG11_bn = _vgg("A", False), _vgg("A", True)
VGG13, VGG13_bn = _vgg("B", False), _vgg("B", True)
VGG16, VGG16_bn = _vgg("D", False), _vgg("D", True)
VGG19, VGG19_bn = _vgg("E", False), _vgg("E", True)
