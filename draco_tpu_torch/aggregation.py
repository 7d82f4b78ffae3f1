"""Robust gradient aggregation rules as (n, d) -> (d,) functions
(draco_tpu/aggregation.py). The reference has no kernel here; these are
plain torch."""

from __future__ import annotations

import torch


def mean(grads: torch.Tensor) -> torch.Tensor:
    """Plain averaging (update mode "normal")."""
    return grads.mean(dim=0)


def geometric_median(grads: torch.Tensor, iters: int = 80,
                     eps: float = 1e-8) -> torch.Tensor:
    """Weiszfeld iteration from the mean, a fixed number of steps."""
    y = mean(grads)
    for _ in range(iters):
        dist = torch.linalg.vector_norm(grads - y[None, :], dim=1)
        w = 1.0 / torch.clamp_min(dist, eps)
        y = (w @ grads) / torch.clamp_min(w.sum(), 1e-30)
    return y


def aggregate(grads: torch.Tensor, mode: str, geomedian_iters: int = 80):
    if mode == "normal":
        return mean(grads)
    if mode == "geometric_median":
        return geometric_median(grads, iters=geomedian_iters)
    raise ValueError(f"aggregation mode {mode!r} is not ported")
