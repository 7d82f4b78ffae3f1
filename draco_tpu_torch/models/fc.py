"""The fully-connected MNIST net (draco_tpu/models/fc.py).

784 → 800 → relu → 500 → relu → 10 → sigmoid. The trailing sigmoid before
the cross-entropy is the reference's quirk, kept.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from draco_tpu_torch.models.layers import Dense, classify, to_compute


class FC_NN(nn.Module):
    dropout_features = ()  # no dropout

    def __init__(self, num_classes: int = 10, in_features: int = 784,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(in_features, 800, compute_dtype=dtype)
        self.Dense_1 = Dense(800, 500, compute_dtype=dtype)
        self.Dense_2 = Dense(500, num_classes)

    def forward(self, x, stats: dict, dropout=None, train: bool = True):
        """x: (B, H, W, C) NHWC, flattened as it lies -> (probabilities,
        {})."""
        x = to_compute(x.reshape(x.shape[0], -1), self.dtype)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return torch.sigmoid(classify(self.Dense_2, x)), {}
