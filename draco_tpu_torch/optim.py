"""SGD with momentum, "aggregated gradient as argument" (draco_tpu/optim.py).

The update takes the decoded or aggregated gradient as an argument, in the
torch formulation the reference pins:

  first step: buf = g;  later: buf = μ·buf + g;  p ← p − lr·buf

Parameters and buffers are updated in place.
"""

from __future__ import annotations

import torch


class SGD:
    def __init__(self, lr: float, momentum: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.bufs = None  # dict of momentum buffers after the first step

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        if self.momentum != 0.0:
            if self.bufs is None:
                self.bufs = {k: g.clone() for k, g in grads.items()}
            else:
                for k, g in grads.items():
                    self.bufs[k].mul_(self.momentum).add_(g)
            d_p = self.bufs
        else:
            d_p = grads
        for k, p in params.items():
            p.sub_(self.lr * d_p[k])
