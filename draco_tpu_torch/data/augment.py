"""CIFAR-10 augmentation on the device (draco_tpu/data/augment.py):
reflect-pad 4, random 32×32 crop, random horizontal flip.

The reference draws (top, left, flip) per sample from a JAX key inside the
step; the port draws the same numbers on the device
(``ops/draws.augment_draws``) and :func:`augment` applies them.
"""

from __future__ import annotations

import torch

PAD = 4


def _reflect(i: torch.Tensor, size: int) -> torch.Tensor:
    """Source index of padded position ``i`` (already shifted by -pad) under
    numpy's "reflect" padding, which mirrors without repeating the edge."""
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= size, 2 * (size - 1) - i, i)


def augment(x: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
            flip: torch.Tensor, pad: int = PAD) -> torch.Tensor:
    """x: (..., H, W, C) NHWC; top/left/flip: (...,) per-sample draws.

    The crop of the reflect-padded image is one gather: output pixel (h, w)
    reads padded (top + h, left + w), mirrored back into the image, and a
    flipped sample reads column W-1-w of its crop."""
    *lead, h, w, c = x.shape
    xf = x.reshape(-1, h, w, c)
    top, left, flip = (t.reshape(-1).to(x.device) for t in (top, left, flip))
    hh = torch.arange(h, device=x.device)
    ww = torch.arange(w, device=x.device)
    rows = _reflect(top[:, None] + hh[None, :] - pad, h)  # (N, H)
    ww = torch.where(flip[:, None] != 0, (w - 1) - ww[None, :], ww[None, :])
    cols = _reflect(left[:, None] + ww - pad, w)  # (N, W)
    b = torch.arange(xf.shape[0], device=x.device)[:, None, None]
    out = xf[b, rows[:, :, None], cols[:, None, :]]
    return out.reshape(x.shape)
