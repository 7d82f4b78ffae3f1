"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for the CPU. There
is no quiet fallback: asking for ``cuda`` on a machine without a card raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def full_f32() -> None:
    """Keep float32 products in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits). Under ``redundancy="simulate"`` the 2s+1 redundant copies of a
    batch gradient then disagree at ~1e-3 relative, which is the size of the
    decode's HEALTH_REL_TOL, so honest rows could be flagged. The reference
    computes in f32 at full precision; so does the port.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. ``cuda`` without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run on the CPU")
        full_f32()
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
