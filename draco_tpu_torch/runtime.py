"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for the CPU. There
is no quiet fallback: asking for ``cuda`` on a machine without a card raises.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to its deterministic algorithms (no autotuning),
    its other settings (TF32 off) left as they are: inside, a convolution
    gives the same bits from call to call and from lane to lane."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small host tensor on ``device``. To the card it goes from pinned
    memory, asynchronously on the current stream: a copy from pageable
    memory would wait for the device to finish its queued work.

    Refused while a CUDA graph captures: the captured copy would read the
    pinned temporary again on every replay, after it was freed. A captured
    step reads its host inputs from device staging buffers instead
    (``training/chunk_graph.py``)."""
    if device.type != "cuda":
        return t
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "runtime.upload inside a CUDA graph capture: a captured copy "
            "would read a freed pinned temporary on replay; stage the input "
            "in the chunk's device buffers")
    return t.pin_memory().to(device, non_blocking=True)


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
