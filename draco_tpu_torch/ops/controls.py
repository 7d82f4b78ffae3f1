"""Negative controls of the kernel audit (``csrc/controls.cu``).

Each seeds one defect that one rule of ``analysis/kernel_audit.py`` exists
to catch; a run of the audit that finds it proves the rule is live.

  * ``control_mistiled_copy``  the counterpart of the deliberately
    mis-tiled ``pallas_call`` ``bad`` (tools/tpu_attn_lowering_check.py:111):
    a copy of x (16, 48) f32 with a (4, 12) tile and a grid of 4, which
    writes the (16, 12) first column block and leaves the other 576
    outputs as they were. The wrapper poisons its output with NaN first, so
    the unwritten elements show. Trips the coverage rule.
  * ``control_overlaunch``  a launch of 1,200-thread blocks, which the
    runtime refuses (cudaErrorInvalidConfiguration, 9): the wrapper raises
    through ``_build.check``. Trips the launch-limit rule.
  * ``control_spill``  a kernel held to 32 registers a thread over a live
    array of 64 floats indexed at run time, which lives in local memory.
    Trips the resource rule.

As for every kernel of the port, each wrapper launches its kernel on a CUDA
tensor and computes its plain version on a CPU tensor (any other device
raises), and counts its launches in ``<wrapper>.launches``. The main path
never calls them.
"""

from __future__ import annotations

import torch

from draco_tpu_torch import _build

TILE = (4, 12)  # the TPU kernel's BlockSpec block
GRID = 4
SHAPE = (TILE[0] * GRID, 48)  # its out_shape
SPILL_LIVE = 64


def _on_cuda(*tensors: torch.Tensor) -> bool:
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"control kernels run on cuda or cpu tensors, got "
                         f"{dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"control kernels take contiguous tensors on one "
                             f"device; got {tuple(t.shape)} on {t.device}")
    return True


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_x(x: torch.Tensor) -> None:
    if x.shape != SHAPE or x.dtype != torch.float32:
        raise ValueError(f"control_mistiled_copy takes a {SHAPE} float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def control_mistiled_copy_plain(x: torch.Tensor, out=None) -> torch.Tensor:
    """What the mis-tiled grid writes: block i copies rows 4i..4i+3 of the
    first column block into ``out`` (NaN-filled if not given); the rest of
    ``out`` keeps what it held."""
    _check_x(x)
    if out is None:
        out = torch.full_like(x, float("nan"))
    rows, cols = TILE
    for i in range(GRID):
        out[i * rows:(i + 1) * rows, :cols] = x[i * rows:(i + 1) * rows, :cols]
    return out


def control_mistiled_copy(x: torch.Tensor) -> torch.Tensor:
    """x (16, 48) f32 -> the NaN-poisoned output with the tiles the grid
    covers copied in."""
    _check_x(x)
    if not _on_cuda(x):
        return control_mistiled_copy_plain(x)
    out = torch.full_like(x, float("nan"))
    err = _build.library("controls").draco_control_mistiled_copy(
        x.data_ptr(), out.data_ptr(), SHAPE[0], SHAPE[1], _stream())
    _build.check(err, "control_mistiled_copy")
    control_mistiled_copy.launches += 1
    return out


control_mistiled_copy.launches = 0


def control_overlaunch_plain(n: int, device="cpu") -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def control_overlaunch(out: torch.Tensor) -> torch.Tensor:
    """Fill ``out`` (n,) f32 with ones, in blocks of 1,200 threads: on the
    card the launch is refused and this raises ``_build.CudaError`` (9)."""
    if out.dim() != 1 or out.dtype != torch.float32:
        raise ValueError(f"control_overlaunch takes an (n,) float32 tensor, "
                         f"got {out.dtype} {tuple(out.shape)}")
    if not _on_cuda(out):
        return out.copy_(control_overlaunch_plain(out.shape[0]))
    err = _build.library("controls").draco_control_overlaunch(
        out.data_ptr(), out.shape[0], _stream())
    _build.check(err, "control_overlaunch")
    control_overlaunch.launches += 1
    return out


control_overlaunch.launches = 0


def control_spill_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """o[i] = Σ_k live[idx[(i + k) mod n] mod 64] with live[k] =
    x[(i + k) mod n]·(k + 1): the kernel's sum, in its order."""
    n = x.shape[0]
    k = torch.arange(SPILL_LIVE, device=x.device)
    j = (torch.arange(n, device=x.device)[:, None] + k[None, :]) % n
    live = x[j] * (k + 1).to(x.dtype)
    picked = live.gather(1, (idx[j] & (SPILL_LIVE - 1)).long())
    out = torch.zeros((n,), dtype=x.dtype, device=x.device)
    for c in range(SPILL_LIVE):
        out = out + picked[:, c]
    return out


def control_spill(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (n,) f32, idx (n,) int32 -> (n,) f32 (``control_spill_plain``)."""
    if x.dim() != 1 or x.dtype != torch.float32 or idx.shape != x.shape \
            or idx.dtype != torch.int32:
        raise ValueError(f"control_spill takes (n,) float32 x and int32 idx, "
                         f"got {x.dtype} {tuple(x.shape)} / {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not _on_cuda(x, idx):
        return control_spill_plain(x, idx)
    out = torch.empty_like(x)
    err = _build.library("controls").draco_control_spill(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], _stream())
    _build.check(err, "control_spill")
    control_spill.launches += 1
    return out


control_spill.launches = 0
