"""The numerics observatory's statistics and the ingest check
(draco_tpu/obs/numerics.py ``_part_counts`` / ``stage_columns``,
draco_tpu/obs/forensics.py ``nonfinite_rows``).

``stage_stats(parts, block)``: a list of float32 parts with d on the last
axis -> the (12,) float32 columns of ``STAT_NAMES`` over all of them —
absmax and rms over the finite elements; the bf16 underflow / overflow,
int8 underflow, non-finite and six exponent-bin counts as fractions of
all elements. The int8 threshold of an element is its block's absmax /
254, blocks of ``block`` elements along each row (restarting at each
row). floor(log2 |x|) comes from the exponent bits, a subnormal's from
its leading mantissa bit, so a value just under 2^k lands in bin k − 1
(the reference's f32 ``log2`` may round it up into the next bin).
``nonfinite_rows(grads)``: (n, ...) -> (n,) bool, the rows holding an Inf
or NaN.

Kernels: ``csrc/numerics.cu`` (one read of each part; the counts exact,
Σ x² summed in f64 in a fixed order). Plain versions: below, in torch,
Σ x² summed in float32 by torch. The wrappers launch the kernel for a
CUDA tensor, run the plain version for a CPU tensor and raise for any
other device; each counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from draco_tpu_torch import _build

# the exponent histogram's bin edges in floor(log2 |x|) (the reference's)
EXP_EDGES = (-32, -16, -8, 0, 8)
NUM_EXP_BINS = len(EXP_EDGES) + 1
STAT_NAMES = ("absmax", "rms", "uf_bf16", "uf_int8", "of_bf16",
              "nonfinite") + tuple(f"exp{i}" for i in range(NUM_EXP_BINS))
# the bits of |x| at the thresholds: 2^-133 (bfloat16's smallest
# subnormal) and bfloat16's largest finite value
TINY_BITS = 0x00010000
BF16_MAX_BITS = 0x7F7F0000
EXP_BITS = 0x7F800000
INT8_STEPS = 254.0  # 2 · 127: the int8 wire's half step at the block scale
# counters a part: n_finite, uf_bf16, of_bf16, uf_int8, exp0..5
NUM_COUNTS = 10
# about the integer and f64 operations an element stage_stats does (the
# masks, the comparisons, the bin, the square and its f64 add)
OPS_PER_ELEMENT = 30


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got "
                         f"{t.device}")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (rows, d)."""
    d = x.shape[-1] if x.dim() else 1
    return x.reshape(-1, d)


# --------------------------------------------------------------------------
# stage_stats
# --------------------------------------------------------------------------


def part_counts_plain(x: torch.Tensor, block: int) -> tuple:
    """One part's raw counts: ((NUM_COUNTS,) int64 — n_finite, uf_bf16,
    of_bf16, uf_int8, then the six exponent bins —, Σ x² over the finite
    elements (0-d float32), absmax (0-d float32))."""
    x = _rows(x.float())
    rows, d = x.shape
    a = x.contiguous().view(torch.int32) & 0x7FFFFFFF
    finite = a < EXP_BITS
    nonzero = finite & (a > 0)
    af = torch.where(finite, a.view(torch.float32), 0.0)  # finite |x|
    absmax = (af.max() if x.numel()
              else torch.zeros((), dtype=torch.float32, device=x.device))
    sumsq = (af * af).sum()  # |x|·|x| rounds as x·x does
    # the int8 threshold: each block's absmax over 254, an f32 division by
    # a 0-d tensor (on the card torch multiplies by a number's reciprocal);
    # a block past d is the row, so the padding stays under d a row
    blk = max(min(block, d), 1)
    nb = -(-d // blk)
    blocks = torch.nn.functional.pad(af, (0, nb * blk - d)).view(rows, nb,
                                                                 blk)
    thr = blocks.amax(dim=-1, keepdim=True) / torch.full(
        (), INT8_STEPS, device=x.device)
    # (count_nonzero: a bool tensor's sum would copy it to int64 first)
    count = torch.count_nonzero
    uf_int8 = count((blocks > 0) & (blocks < thr))
    # floor(log2 |x|) < k ⟺ the exponent field < k + 127 (a subnormal,
    # field 0, lies below every edge): the bins are the differences of the
    # counts below each edge
    below = [count(nonzero & (a < ((k + 127) << 23))) for k in EXP_EDGES]
    lt = torch.stack(below + [count(nonzero)])
    exp = lt - torch.cat([lt.new_zeros(1), lt[:-1]])
    counts = torch.cat([torch.stack([
        count(finite), count(nonzero & (a < TINY_BITS)),
        count(finite & (a > BF16_MAX_BITS)), uf_int8]), exp])
    return counts, sumsq, absmax


def finish_columns(counts: torch.Tensor, sumsq: torch.Tensor,
                   absmax: torch.Tensor, total: int) -> torch.Tensor:
    """The (12,) STAT_NAMES columns from the summed counts, Σ x² and
    absmax of ``total`` elements, in float32 as the kernel finishes them."""
    f32 = torch.float32
    dev = counts.device
    tot = torch.full((), float(total), dtype=f32, device=dev)
    denom = torch.clamp_min(tot, 1.0)
    c = counts.to(f32)
    rms = torch.sqrt(sumsq.to(f32) / torch.clamp_min(c[0], 1.0))
    frac = c / denom
    return torch.cat([torch.stack([absmax.to(f32), rms, frac[1], frac[3],
                                   frac[2], (tot - c[0]) / denom]),
                      frac[4:]])


def stage_stats_plain(parts, block: int) -> torch.Tensor:
    acc = [part_counts_plain(p, block) for p in parts]
    counts = torch.stack([c for c, _, _ in acc]).sum(dim=0)
    sumsq = torch.stack([s for _, s, _ in acc]).sum()
    absmax = torch.stack([m for _, _, m in acc]).max()
    return finish_columns(counts, sumsq, absmax,
                          sum(p.numel() for p in parts))


def stage_stats(parts, block: int) -> torch.Tensor:
    """The (12,) float32 STAT_NAMES columns of one stage over ``parts``
    (float32, d on the last axis; a kernel launch takes one or two parts of
    one shape, more are folded by the plain version's rule)."""
    parts = list(parts)
    block = max(int(block), 1)
    dev = parts[0].device
    for p in parts:
        _check(p, "stage_stats")
        if p.device != dev:
            raise ValueError(f"stage_stats: parts on {p.device} and {dev}")
    if dev.type == "cpu":
        return stage_stats_plain(parts, block)
    shape = parts[0].shape
    if len(parts) > 2 or any(p.shape != shape or p.dtype != torch.float32
                             or not p.is_contiguous() for p in parts):
        raise ValueError(
            f"stage_stats takes one or two contiguous float32 parts of one "
            f"shape, got {[(p.dtype, tuple(p.shape)) for p in parts]}")
    out = torch.empty((len(STAT_NAMES),), dtype=torch.float32, device=dev)
    stage_stats_launch(parts, block, out)
    stage_stats.launches += 1
    return out


def stage_grid(rows: int, d: int, block: int) -> int:
    return int(_build.library("numerics").draco_stage_grid(rows, d, block))


def stage_stats_launch(parts, block: int, out: torch.Tensor) -> None:
    """The kernels into ``out`` ((12,) float32): the partial pass over the
    parts, then the finishing warp."""
    x = _rows(parts[0])
    rows, d = x.shape
    grid = stage_grid(rows, d, block)
    # NUM_COUNTS u64 counters, the absmax's bits, then the f64 partials
    work = torch.empty((NUM_COUNTS + 1 + len(parts) * grid,),
                       dtype=torch.int64, device=x.device)
    total = float(sum(p.numel() for p in parts))
    err = _build.library("numerics").draco_stage_stats(
        parts[0].data_ptr(), parts[1].data_ptr() if len(parts) > 1 else None,
        rows, d, block, work.data_ptr(), out.data_ptr(), total,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "stage_stats")


def stage_bytes(parts) -> int:
    """The bytes stage_stats must move: every element read once, the 12
    columns written."""
    return sum(4 * p.numel() for p in parts) + 4 * len(STAT_NAMES)


# --------------------------------------------------------------------------
# nonfinite_rows
# --------------------------------------------------------------------------


def nonfinite_rows_plain(grads: torch.Tensor) -> torch.Tensor:
    g = grads.reshape(grads.shape[0], -1)
    return ~torch.isfinite(g).all(dim=1)


def nonfinite_rows(grads: torch.Tensor) -> torch.Tensor:
    """(n, ...) -> (n,) bool: the rows holding an Inf or NaN."""
    _check(grads, "nonfinite_rows")
    if grads.device.type == "cpu":
        return nonfinite_rows_plain(grads)
    if grads.dtype != torch.float32 or not grads.is_contiguous() \
            or grads.dim() < 1:
        raise ValueError(f"nonfinite_rows takes contiguous float32 rows, "
                         f"got {grads.dtype} {tuple(grads.shape)} "
                         f"(contiguous={grads.is_contiguous()})")
    out = torch.empty((grads.shape[0],), dtype=torch.bool,
                      device=grads.device)
    nonfinite_rows_launch(grads, out)
    nonfinite_rows.launches += 1
    return out


def nonfinite_rows_launch(grads, out) -> None:
    """The kernel into ``out`` ((n,) bool, zeroed by the launcher)."""
    n = grads.shape[0]
    length = grads.numel() // n if n else 0
    err = _build.library("numerics").draco_nonfinite_rows(
        grads.data_ptr(), out.data_ptr(), n, length,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "nonfinite_rows")


stage_stats.launches = 0
nonfinite_rows.launches = 0
