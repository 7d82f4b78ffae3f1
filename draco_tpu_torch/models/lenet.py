"""LeNet (draco_tpu/models/lenet.py).

conv(→20, 5×5, VALID) → maxpool2 → relu → conv(20→50) → maxpool2 → relu →
fc(→500) → fc(500→10), as the reference: relu comes *after* each pool,
and none follows the first fc. The first fc reads the NHWC flatten of the
(4, 4, 50) map on MNIST, so its (800, 500) kernel and its flat gradient
are the reference's coordinate for coordinate.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from draco_tpu_torch.models.layers import (
    Conv,
    Dense,
    classify,
    nhwc_flatten,
    to_compute,
)


class LeNet(nn.Module):
    dropout_features = ()  # no dropout

    def __init__(self, num_classes: int = 10, in_channels: int = 1,
                 size: int = 28, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(in_channels, 20, 5, compute_dtype=dtype)
        self.Conv_1 = Conv(20, 50, 5, compute_dtype=dtype)
        side = ((size - 4) // 2 - 4) // 2
        self.Dense_0 = Dense(side * side * 50, 500, compute_dtype=dtype)
        self.Dense_1 = Dense(500, num_classes)

    def forward(self, x, stats: dict, dropout=None, train: bool = True):
        """x: (B, H, W, C) NHWC -> (logits, {}): no BatchNorm."""
        x = to_compute(x, self.dtype).permute(0, 3, 1, 2)
        x = F.relu(F.max_pool2d(self.Conv_0(x), 2, 2))
        x = F.relu(F.max_pool2d(self.Conv_1(x), 2, 2))
        x = self.Dense_0(nhwc_flatten(x))
        return classify(self.Dense_1, x), {}
