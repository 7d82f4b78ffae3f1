"""The repetition code's row fingerprints (draco_tpu/coding/repetition.py
``_row_fingerprints``).

``row_fingerprints(rows, salts)`` folds each row of an (n, d) f32 or bf16
matrix into two salted 32-bit hashes of its raw bits, which the vote
compares instead of the rows (``coding/repetition.py``). Kernel:
``csrc/vote.cu``; plain version: ``coding.repetition._row_fingerprints``
(int64 arithmetic masked to 32 bits: PyTorch has no uint32 shift, add or
sum). The wrapper launches the kernel on a CUDA tensor, runs the plain
version on a CPU tensor, and raises for any other device; it counts its
launches in ``row_fingerprints.launches``. Both return the hashes as
(n, 2) int64 holding the uint32 values.

The salts are a (2,) int32 tensor on the rows' device holding the two
uint32 salts' bits (``salts_tensor``): the kernel reads them from device
memory, so a step captured in a CUDA graph reads each replay's own.
"""

from __future__ import annotations

from typing import Optional

import torch

from draco_tpu_torch import _build

# the reference's fixed salts when no key is given (repetition.py:112-113)
PUBLIC_SALTS = (0x9E3779B1, 0xC2B2AE35)
MASK32 = 0xFFFFFFFF
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# 32-bit integer operations an element, as csrc/vote.cu writes them:
# posmix (a multiply-add and a splitmix32's 8), and per hash a xor, two
# splitmix32, an add and the running sum
OPS_PER_ELEMENT = 9 + 2 * 19

_PUBLIC: dict = {}  # device -> the public salts as a device tensor


def salts_tensor(salts, device="cpu") -> torch.Tensor:
    """Two uint32 salts -> the (2,) int32 tensor of their bits."""
    vals = [int(s) & MASK32 for s in salts]
    return torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in vals],
                        dtype=torch.int32, device=device)


def as_int32_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 of the same bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def public_salts(device) -> torch.Tensor:
    """The public salts on ``device``, made once a device."""
    dev = torch.device(device)
    if dev not in _PUBLIC:
        _PUBLIC[dev] = salts_tensor(PUBLIC_SALTS, dev)
    return _PUBLIC[dev]


def fingerprint_ops(n: int, d: int) -> int:
    """The kernel's 32-bit integer operations on n rows of d elements."""
    return OPS_PER_ELEMENT * n * d


def row_fingerprints(rows: torch.Tensor,
                     salts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, d) f32 or bf16 rows -> (n, 2) int64: each row's two uint32
    hashes (h1, h2). ``salts``: (2,) int32 (``salts_tensor``); None = the
    public salts."""
    if salts is None:
        salts = public_salts(rows.device)
    dev = rows.device
    if dev.type == "cpu":
        from draco_tpu_torch.coding.repetition import _row_fingerprints

        return _row_fingerprints(rows, salts)
    if dev.type != "cuda":
        raise ValueError(f"row_fingerprints runs on cuda or cpu tensors, "
                         f"got {dev}")
    if rows.dim() != 2 or rows.dtype not in ELEMENT_BYTES \
            or not rows.is_contiguous():
        raise ValueError(f"row_fingerprints takes contiguous (n, d) float32 "
                         f"or bfloat16 rows, got {rows.dtype} "
                         f"{tuple(rows.shape)} (contiguous="
                         f"{rows.is_contiguous()})")
    if salts.device != dev or salts.dtype != torch.int32 \
            or salts.shape != (2,):
        raise ValueError(f"row_fingerprints: salts must be (2,) int32 on "
                         f"{dev}, got {salts.dtype} {tuple(salts.shape)} on "
                         f"{salts.device}")
    out = torch.empty((rows.shape[0], 2), dtype=torch.int32, device=dev)
    row_fingerprints_launch(rows, salts, out)
    row_fingerprints.launches += 1
    return out.to(torch.int64) & MASK32


def row_fingerprints_launch(rows, salts, out) -> None:
    """The kernel into ``out`` ((n, 2) int32, zeroed by the launcher)."""
    n, d = rows.shape
    err = _build.library("vote").draco_row_fingerprints(
        rows.data_ptr(), salts.data_ptr(), out.data_ptr(), n, d,
        ELEMENT_BYTES[rows.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "row_fingerprints")


row_fingerprints.launches = 0
