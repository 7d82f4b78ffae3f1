"""Complex-arithmetic products of the cyclic gradient code
(draco_tpu/ops/coded.py).

  * ``complex_matmul``    encode:     (Wr + i·Wi) @ G            for real G
  * ``complex_project``   decode in:  (Rr + i·Ri) @ f            for real f
  * ``complex_recombine`` decode out: Re[(vr + i·vi)ᵀ (Rr + i·Ri)]

and their segmented forms over column segments [a_j, a_{j+1}) of the
segmented decode (``coding/cyclic.decode_segments``), one launch for all
segments:

  * ``complex_project_segments``   e[j] = R[:, a_j:a_{j+1}] @ f[a_j:a_{j+1}]
  * ``complex_recombine_segments`` out[a_j:a_{j+1}] = Re[v_jᵀ R[:, a_j:a_{j+1}]]

They read the whole (n, d) operands in place through a :class:`SegmentPlan`
(``segment_plan``): the column tiles of the cuts as an int32 table on the
card, built and uploaded once per (cuts, device) and cached, so a step —
and a CUDA graph capture — uploads nothing.

Each wrapper launches its CUDA kernel (``csrc/coded.cu``) on a CUDA tensor
and computes its plain version (``*_plain``, the reference's XLA
formulation) on a CPU tensor; any other device raises. A wrapper counts its
kernel launches in ``<wrapper>.launches``. The launch itself (``*_launch``)
writes into outputs the caller allocated, which lets the kernel audit
(``analysis/kernel_audit.py``) hand it guarded buffers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from draco_tpu_torch import _build
from draco_tpu_torch.runtime import upload

# the most columns a tile of a segment plan holds: one block of 256 threads
# takes a tile, 8 columns a thread
SEGMENT_TILE = 2048


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs (checked for the kernel), False for CPU ones."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"coded ops run on cuda or cpu tensors, got {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "coded kernels take contiguous float32 tensors on one device; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    return True


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def complex_matmul_plain(w_re, w_im, g, out=None):
    if out is None:
        return w_re @ g, w_im @ g
    torch.matmul(w_re, g, out=out[0])
    torch.matmul(w_im, g, out=out[1])
    return out


def complex_matmul(w_re, w_im, g, out=None):
    """(Wr + i·Wi) @ G for real G: W (m, n), G (n, d) -> (re, im), (m, d).
    ``out``: an (re, im) pair of contiguous (m, d) tensors to write into
    (the tree's encode writes each group's rows in place)."""
    if not _on_cuda(g, w_re, w_im, *(out or ())):
        return complex_matmul_plain(w_re, w_im, g, out)
    (m, n), d = w_re.shape, g.shape[1]
    if w_im.shape != (m, n) or g.shape[0] != n or n > 64 or m > 64:
        raise ValueError(f"complex_matmul: W {tuple(w_re.shape)} / "
                         f"{tuple(w_im.shape)}, G {tuple(g.shape)} (n, m <= 64)")
    if out is None:
        out_re = torch.empty((m, d), dtype=torch.float32, device=g.device)
        out_im = torch.empty_like(out_re)
    else:
        out_re, out_im = out
        if out_re.shape != (m, d) or out_im.shape != (m, d) \
                or out_re.dtype != torch.float32 \
                or out_im.dtype != torch.float32:
            raise ValueError(f"complex_matmul: out {tuple(out_re.shape)} / "
                             f"{tuple(out_im.shape)}, expected ({m}, {d}) "
                             f"float32")
    complex_matmul_launch(w_re, w_im, g, out_re, out_im)
    complex_matmul.launches += 1
    return out_re, out_im


def complex_matmul_launch(w_re, w_im, g, out_re, out_im) -> None:
    """The encode kernel into ``out_re``, ``out_im`` (m, d)."""
    (m, n), d = w_re.shape, g.shape[1]
    err = _build.library("coded").draco_complex_matmul(
        w_re.data_ptr(), w_im.data_ptr(), g.data_ptr(), out_re.data_ptr(),
        out_im.data_ptr(), m, n, d, _stream())
    _build.check(err, "complex_matmul")


complex_matmul.launches = 0


# --------------------------------------------------------------------------
# decode projection
# --------------------------------------------------------------------------

def complex_project_plain(r_re, r_im, f):
    return r_re @ f, r_im @ f


def complex_project(r_re, r_im, f):
    """(Rr + i·Ri) @ f for real f (d,): returns (re, im), each (n,)."""
    if not _on_cuda(r_re, r_im, f):
        return complex_project_plain(r_re, r_im, f)
    n, d = r_re.shape
    if r_im.shape != (n, d) or f.shape != (d,) or d < 1:
        raise ValueError(f"complex_project: R {tuple(r_re.shape)} / "
                         f"{tuple(r_im.shape)}, f {tuple(f.shape)}")
    chunks = project_chunks(n, d)
    part = torch.empty((2, n, chunks), dtype=torch.float32, device=f.device)
    e = torch.empty((2, n), dtype=torch.float32, device=f.device)
    complex_project_launch(r_re, r_im, f, part[0], part[1], e[0], e[1])
    complex_project.launches += 1
    return e[0], e[1]


def project_chunks(n: int, d: int) -> int:
    """Pass-1 blocks of the projection of n rows of length d (one whole
    wave of the card): its (n, chunks) partials."""
    return _build.library("coded").draco_project_chunks(n, d)


def complex_project_launch(r_re, r_im, f, part_re, part_im, e_re,
                           e_im) -> None:
    """Both passes of the projection: the (n, chunks) partials, then
    ``e_re``, ``e_im`` (n,)."""
    n, d = r_re.shape
    err = _build.library("coded").draco_complex_project(
        r_re.data_ptr(), r_im.data_ptr(), f.data_ptr(), part_re.data_ptr(),
        part_im.data_ptr(), e_re.data_ptr(), e_im.data_ptr(), n, d,
        part_re.shape[1], _stream())
    _build.check(err, "complex_project")


complex_project.launches = 0


# --------------------------------------------------------------------------
# decode recombination
# --------------------------------------------------------------------------

def complex_recombine_plain(v_re, v_im, r_re, r_im):
    return v_re @ r_re - v_im @ r_im


def complex_recombine(v_re, v_im, r_re, r_im):
    """Re[(vr + i·vi)ᵀ (Rr + i·Ri)] = vrᵀRr − viᵀRi: returns real (d,)."""
    if not _on_cuda(r_re, r_im, v_re, v_im):
        return complex_recombine_plain(v_re, v_im, r_re, r_im)
    n, d = r_re.shape
    if r_im.shape != (n, d) or v_re.shape != (n,) or v_im.shape != (n,):
        raise ValueError(f"complex_recombine: v {tuple(v_re.shape)} / "
                         f"{tuple(v_im.shape)}, R {tuple(r_re.shape)} / "
                         f"{tuple(r_im.shape)}")
    out = torch.empty((d,), dtype=torch.float32, device=r_re.device)
    complex_recombine_launch(v_re, v_im, r_re, r_im, out)
    complex_recombine.launches += 1
    return out


def complex_recombine_launch(v_re, v_im, r_re, r_im, out) -> None:
    """The recombination kernel into ``out`` (d,)."""
    n, d = r_re.shape
    err = _build.library("coded").draco_complex_recombine(
        v_re.data_ptr(), v_im.data_ptr(), r_re.data_ptr(), r_im.data_ptr(),
        out.data_ptr(), n, d, _stream())
    _build.check(err, "complex_recombine")


complex_recombine.launches = 0


# --------------------------------------------------------------------------
# the segment plan and the segmented decode products
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Column segments [bounds[j], bounds[j+1]) cut into tiles of at most
    SEGMENT_TILE columns, none straddling a cut. ``table`` (int32, on the
    plan's device) = [segment of each tile (T), first column (T), end
    column (T), first tile of each segment (S + 1)]: what the kernels
    read."""

    bounds: tuple
    tiles: int
    table: torch.Tensor

    @property
    def segments(self) -> int:
        return len(self.bounds) - 1


def plan_table(bounds) -> np.ndarray:
    """The int32 table of a :class:`SegmentPlan` for ``bounds`` (strictly
    increasing column cuts, at least two)."""
    bounds = tuple(int(b) for b in bounds)
    if len(bounds) < 2 or bounds[0] < 0 or any(
            b <= a for a, b in zip(bounds[:-1], bounds[1:])):
        raise ValueError(f"segment cuts must increase strictly from >= 0, "
                         f"got {bounds[:8]}{'...' if len(bounds) > 8 else ''}")
    if bounds[-1] >= 2 ** 31:
        raise ValueError(f"segment cuts past 2^31 columns: {bounds[-1]}")
    seg, lo, first = [], [], [0]
    for j, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        starts = np.arange(a, b, SEGMENT_TILE, dtype=np.int64)
        seg.append(np.full(len(starts), j, dtype=np.int64))
        lo.append(starts)
        first.append(first[-1] + len(starts))
    seg, lo = np.concatenate(seg), np.concatenate(lo)
    # a tile ends at the next tile's start, or at its segment's end
    hi = np.minimum(lo + SEGMENT_TILE, np.asarray(bounds[1:])[seg])
    return np.concatenate([seg, lo, hi, first]).astype(np.int32)


_PLANS: dict = {}


def segment_plan(bounds, device) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``bounds`` on ``device``, built and
    uploaded at its first use and cached: build it before a CUDA graph
    captures (an upload under capture raises)."""
    key = (tuple(int(b) for b in bounds), str(torch.device(device)))
    plan = _PLANS.get(key)
    if plan is None:
        table = plan_table(key[0])
        tiles = (len(table) - len(key[0])) // 3
        plan = SegmentPlan(key[0], tiles,
                           upload(torch.from_numpy(table),
                                  torch.device(device)))
        _PLANS[key] = plan
    return plan


def _segments(plan: SegmentPlan):
    return zip(plan.bounds[:-1], plan.bounds[1:])


def check_plan(plan: SegmentPlan, d: int, dev, what: str) -> None:
    """Raise unless ``plan``'s cuts lie in [0, d] and its table on ``dev``."""
    if plan.bounds[-1] > d or plan.table.device != dev:
        raise ValueError(f"{what}: a plan of cuts up to {plan.bounds[-1]} on "
                         f"{plan.table.device} for d={d} on {dev}")


def complex_project_segments_plain(r_re, r_im, f, plan: SegmentPlan):
    """One projection a segment, as the reference's per-segment calls."""
    e = [(r_re[:, a:b] @ f[a:b], r_im[:, a:b] @ f[a:b])
         for a, b in _segments(plan)]
    return (torch.stack([x[0] for x in e]), torch.stack([x[1] for x in e]))


def complex_project_segments(r_re, r_im, f, plan: SegmentPlan):
    """(Rr + i·Ri)[:, a_j:b_j] @ f[a_j:b_j] for every segment of ``plan``:
    returns (re, im), each (S, n) — the locator's stack of columns."""
    if not _on_cuda(r_re, r_im, f):
        return complex_project_segments_plain(r_re, r_im, f, plan)
    n, d = r_re.shape
    if r_im.shape != (n, d) or f.shape != (d,):
        raise ValueError(f"complex_project_segments: R {tuple(r_re.shape)} / "
                         f"{tuple(r_im.shape)}, f {tuple(f.shape)}")
    check_plan(plan, d, f.device, "complex_project_segments")
    part = torch.empty((2, n, plan.tiles), dtype=torch.float32,
                       device=f.device)
    e = torch.empty((2, plan.segments, n), dtype=torch.float32,
                    device=f.device)
    complex_project_segments_launch(r_re, r_im, f, plan, part[0], part[1],
                                    e[0], e[1])
    complex_project_segments.launches += 1
    return e[0], e[1]


def complex_project_segments_launch(r_re, r_im, f, plan, part_re, part_im,
                                    e_re, e_im) -> None:
    """Both passes of the segmented projection: the (n, tiles) partials,
    then ``e_re``, ``e_im`` (S, n)."""
    n, d = r_re.shape
    err = _build.library("coded").draco_complex_project_segments(
        r_re.data_ptr(), r_im.data_ptr(), f.data_ptr(),
        plan.table.data_ptr(), plan.tiles, plan.segments,
        part_re.data_ptr(), part_im.data_ptr(), e_re.data_ptr(),
        e_im.data_ptr(), n, d, _stream())
    _build.check(err, "complex_project_segments")


complex_project_segments.launches = 0


def complex_recombine_segments_plain(v_re, v_im, r_re, r_im,
                                     plan: SegmentPlan):
    """One recombination a segment into one (d,) output, as the
    reference's ``_recombine_layers_fused``."""
    out = torch.zeros((r_re.shape[1],), dtype=torch.float32,
                      device=r_re.device)
    for j, (a, b) in enumerate(_segments(plan)):
        out[a:b] = complex_recombine_plain(v_re[j], v_im[j], r_re[:, a:b],
                                           r_im[:, a:b])
    return out


def complex_recombine_segments(v_re, v_im, r_re, r_im, plan: SegmentPlan):
    """Re[(vr_j + i·vi_j)ᵀ (Rr + i·Ri)[:, a_j:b_j]] into columns [a_j, b_j)
    for every segment j of ``plan``: v (S, n), R (n, d) -> real (d,)."""
    if not _on_cuda(r_re, r_im, v_re, v_im):
        return complex_recombine_segments_plain(v_re, v_im, r_re, r_im, plan)
    n, d = r_re.shape
    if (r_im.shape != (n, d) or v_re.shape != (plan.segments, n)
            or v_im.shape != (plan.segments, n)):
        raise ValueError(f"complex_recombine_segments: v {tuple(v_re.shape)}"
                         f" / {tuple(v_im.shape)} for {plan.segments} "
                         f"segments, R {tuple(r_re.shape)} / "
                         f"{tuple(r_im.shape)}")
    check_plan(plan, d, r_re.device, "complex_recombine_segments")
    out = torch.empty((d,), dtype=torch.float32, device=r_re.device)
    complex_recombine_segments_launch(v_re, v_im, r_re, r_im, plan, out)
    complex_recombine_segments.launches += 1
    return out


def complex_recombine_segments_launch(v_re, v_im, r_re, r_im, plan,
                                      out) -> None:
    """The segmented recombination kernel into ``out`` (d,)."""
    n, d = r_re.shape
    err = _build.library("coded").draco_complex_recombine_segments(
        v_re.data_ptr(), v_im.data_ptr(), r_re.data_ptr(), r_im.data_ptr(),
        plan.table.data_ptr(), plan.tiles, out.data_ptr(), n, d, _stream())
    _build.check(err, "complex_recombine_segments")


complex_recombine_segments.launches = 0
