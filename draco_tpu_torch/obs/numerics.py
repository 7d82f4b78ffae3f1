"""The real narrow wire (draco_tpu/obs/numerics.py, its wire part).

``cfg.wire_dtype`` picks what the worker→aggregator wire carries: f32, or
bf16 / int8 buffers that the decode widens back to f32. int8 rows carry
symmetric per-block scales (absmax/127 over ``cfg.shadow_block`` elements
of a row). Quantizing and widening are plain torch, as the reference does
them outside Pallas; the decode kernels (``ops/decode_kernels``) read the
narrow buffers and widen in registers.

Rounding is to nearest (bf16: round half to even; int8: ``torch.round``,
half to even like ``jnp.round``), or stochastic (``cfg.shadow_round``, the
wire's rounding mode as in the reference): one (d,) draw shared by every
row of the step, so rows equal bit for bit quantize bit for bit alike (the
vote's soundness condition). bf16 adds the draw's low 16 bits to the f32
bits and truncates; int8 takes ``floor(x/scale + u)``. The draws are the
reference's own (``wire_step_key``: ``fold_in(key(seed + 17), step)``, the
imaginary part ``fold_in`` of it with 1), made on the card by the
``round_draw`` kernel (``ops/draws.py``) from the step on the device. Both
modes give the reference's buffers bit for bit (``tests/test_torch_wire.py``,
``tests/test_torch_draws.py``).

The reference's observatory, all riding the step's metric row:

* the numerics columns (``cfg.numerics_watch="on"``): twelve statistics
  (``STAT_NAMES``) of three stages — the pre-encode gradients (``grad``),
  the codewords on the wire (``wire``) and the decoded aggregate
  (``agg``) — from the ``stage_stats`` kernel (``ops/numerics.py``),
  finished on the device: absmax and rms over the finite elements, the
  bf16 underflow / overflow, int8 underflow, non-finite and exponent-bin
  fractions of all elements;
* the shadow-quantized wire (``cfg.shadow_wire`` bf16 | int8): the f32
  codewords rounded by the real wire's cores (``quantize_rows``, at
  ``shadow_block`` and ``shadow_round``; stochastic rounding draws at seed
  + 11) and decoded a second time beside the f32 decode, which alone
  updates the parameters; the ``SHADOW_NAMES`` columns compare the two
  (``cyclic_shadow``, ``majvote_shadow``, ``approx_shadow``), a
  non-finite comparison at ``SHADOW_SENTINEL``;
* the wire ledger (``wire_ledger``): a step's logical and physical wire
  bytes from the shapes, status.json's ``wire`` block.

The segmented wire (``cfg.wire_segments`` S > 1) cuts the d axis at the
reference's bounds (``wire_segment_bounds``): every interior cut a multiple
of SEGMENT_QUANTUM, or of the int8 scale block where that does not divide
it, so no scale block straddles a cut and the narrow buffers of the whole
row are the segments' buffers.

The constants are the reference's, as its tools/wire_study.py derived them:
the locator λ per dtype, the per-(n, s, dtype) cyclic flag thresholds and
the residual slack of the approx certificate on a narrow wire.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from draco_tpu_torch.ops import draws
# the statistics' names and the exponent histogram's bin edges in
# floor(log2 |x|): (-inf,-32) [-32,-16) [-16,-8) [-8,0) [0,8) [8,inf)
from draco_tpu_torch.ops.numerics import (  # noqa: F401
    EXP_EDGES,
    NUM_EXP_BINS,
    STAT_NAMES,
)

# int8 quantization levels per sign (symmetric per-block scale absmax/127)
INT8_LEVELS = 127.0
# default per-block scale granularity along the last axis (cfg.shadow_block)
DEFAULT_BLOCK = 256
# the quiet NaN a bf16 wire carries (the reference's cast gives this one)
BF16_NAN_BITS = 0x7FC0

WIRE_DTYPES = ("f32", "bf16", "int8")

# λ of the cyclic locator solve per wire dtype: the syndrome-significance
# gate and the solve's noise-floor cutoff (coding/cyclic.locator_core);
# λ = 0 on the f32 wire is the exact path
WIRE_LOCATOR_LAMBDA = {"f32": 0.0, "bf16": 2.0 ** -8, "int8": 2.0 ** -6}

# quantization-aware cyclic flag thresholds (relative amplitude, the role
# of coding/cyclic.HEALTH_REL_TOL on the f32 wire), per (n, s, dtype)
WIRE_REL_TOL_TABLE = {
    (8, 1, "bf16"): 5e-2, (8, 1, "int8"): 1.5e-1,
    (32, 3, "bf16"): 2e-1, (32, 3, "int8"): 2.8e-1,
}

# slack added to the approx certificate (residual ≤ bound) on a narrow
# wire: the measured residual carries the quantization error, the bound
# prices drops only
WIRE_RESIDUAL_SLACK = {"f32": 0.0, "bf16": 2e-2, "int8": 1e-1}

# the autopilot's wire dial (control/autopilot.py): wire_widen moves the
# wire one step f32-ward, wire_narrow one step back toward the configured
# dtype (``narrow_toward``)
WIRE_WIDEN = {"int8": "bf16", "bf16": "f32", "f32": "f32"}

# per-dtype threshold band for shapes outside the table, at s ≤ 2; also
# the shadow decode's flag threshold
SHADOW_REL_TOL = {"bf16": 5e-2, "int8": 1.5e-1}

# smallest positive bfloat16 subnormal: a smaller f32 flushes to zero on a
# bf16 wire; largest finite bfloat16 (0x7F7F): a larger f32 rounds to inf
BF16_TINY = 2.0 ** -133
BF16_MAX = 3.3895313892515355e38
NUMERICS_STAGES = ("grad", "wire", "agg")
NUMERICS_PREFIX = "nx_"
SHADOW_NAMES = ("shadow_err", "shadow_residual", "shadow_flag_agree",
                "shadow_det_flagged", "shadow_det_tp")
# a fault-poisoned shadow comparison's value (every real one is >= 0)
SHADOW_SENTINEL = -1.0
SHADOW_WIRES = ("off", "bf16", "int8")


def wire_rel_tol(n: int, s: int, dtype: str) -> float:
    """The cyclic flag threshold a narrow wire decodes with at (n, s): the
    table's entry, else SHADOW_REL_TOL[dtype] for s ≤ 2, else ``inf`` (no
    usable threshold is known; ``config.validate`` rejects the shape)."""
    key = (int(n), int(s), dtype)
    if key in WIRE_REL_TOL_TABLE:
        return WIRE_REL_TOL_TABLE[key]
    if int(s) <= 2:
        return SHADOW_REL_TOL[dtype]
    return float("inf")


def wire_locator_lambda(dtype: str) -> float:
    return WIRE_LOCATOR_LAMBDA[dtype]


def wire_residual_slack(dtype: str) -> float:
    return WIRE_RESIDUAL_SLACK.get(dtype, 0.0)


def narrow_toward(current: str, target: str) -> str:
    """One step from ``current`` along f32 -> bf16 -> int8 toward
    ``target``, never past it; ``current`` when it is not wider."""
    order = ("f32", "bf16", "int8")
    ci, ti = order.index(current), order.index(target)
    return order[min(ci + 1, ti)] if ci < ti else current


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """(..., d) -> (..., ⌈d/block⌉, block), the ragged tail padded with 0."""
    d = x.shape[-1]
    nb = -(-d // block)
    if nb * block != d:
        x = F.pad(x, (0, nb * block - d))
    return x.reshape(x.shape[:-1] + (nb, block))


def _block_absmax(af: torch.Tensor, block: int) -> torch.Tensor:
    """Per-block maximum of ``af`` (already the finite-masked |x|) along
    the last axis, blocks padded with 0: (..., ⌈d/block⌉). The reference
    broadcasts it back to (..., d); the port keeps one value per block."""
    return _blocks(af, block).amax(dim=-1)


def _round_step_key(cfg, step, offset: int):
    """The stochastic-rounding key of ``step`` at salt ``offset``, or None
    under nearest rounding: ``fold_in(key(seed + offset), step)``."""
    if getattr(cfg, "shadow_round", "nearest") != "stochastic":
        return None
    return draws.step_key(cfg.seed + offset, 0 if step is None else step)


def shadow_step_key(cfg, step=None):
    """The shadow quantizer's stochastic-rounding key (seed + 11)."""
    return _round_step_key(cfg, step, draws.SHADOW_SALT)


def wire_step_key(cfg, step=None):
    """The real wire's stochastic-rounding key (seed + 17); ``round_draw``
    computes it in the kernel."""
    return _round_step_key(cfg, step, draws.WIRE_SALT)


def _bf16_stochastic(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Stochastic bf16 rounding of f32 ``x`` (..., d) with the (d,) draw
    ``r`` (the low 16 bits of ``bits``): ``(bits(x) + r) & 0xFFFF0000``,
    the high half as the bf16, a NaN as its sign and the reference's
    0x7FC0. In int32: the add wraps as the uint32 add does, and the
    arithmetic shift leaves the high half sign-extended, in int16's range."""
    hi = (x.contiguous().view(torch.int32) + r.to(torch.int32)) >> 16
    nan = ((hi & 0x7F80) == 0x7F80) & ((hi & 0x7F) != 0)
    hi = torch.where(nan, (hi & -0x8000) | BF16_NAN_BITS, hi)
    return hi.to(torch.int16).view(torch.bfloat16)


def _int8_levels_and_scale(x: torch.Tensor, block: int, u=None):
    """Symmetric per-block int8 quantization: f32 rows (..., d) ->
    ``(q, scale)``, ``q`` the levels in [-127, 127] held in f32 and
    ``scale`` (..., ⌈d/block⌉) f32 = absmax/127 (1 for an all-zero block).
    Round to nearest, or ``floor(x/scale + u)`` with the (d,) uniform draw
    ``u``. Non-finite inputs map to 0: an integer wire has no NaN."""
    block = max(int(block), 1)
    d = x.shape[-1]
    xf = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    bmax = _block_absmax(xf.abs(), block)
    # divided by a 0-d tensor, not a Python number: on the card torch
    # multiplies by the reciprocal of a number, which can round otherwise
    levels = torch.full((), INT8_LEVELS, device=x.device)
    scale = torch.where(bmax > 0, bmax / levels, torch.ones_like(bmax))
    y = (_blocks(xf, block) / scale[..., None]).flatten(-2)[..., :d]
    q = torch.round(y) if u is None else torch.floor(y + u)
    return q.clamp_(-INT8_LEVELS, INT8_LEVELS), scale


def narrow_wire_rows(x: torch.Tensor, mode: str,
                     block: int = DEFAULT_BLOCK, draw=None) -> dict:
    """Round (..., d) f32 wire rows into the narrow buffers that cross the
    wire: bf16 ``{"q": bfloat16 (..., d)}``, or int8 ``{"q": int8 (..., d),
    "scale": f32 (..., ⌈d/block⌉)}``. ``draw``: the (d,) stochastic-rounding
    draw of the mode (``draws.round_draw``), None to round to nearest."""
    x = x.float()
    if mode == "bf16":
        if draw is not None:
            return {"q": _bf16_stochastic(x, draw)}
        # NaN passes through as the reference's one bit pattern: casts on
        # the CPU and the card give NaNs of other signs and payloads
        nan = torch.full((), BF16_NAN_BITS, dtype=torch.int16,
                         device=x.device).view(torch.bfloat16)
        return {"q": torch.where(torch.isnan(x), nan, x.to(torch.bfloat16))}
    if mode != "int8":
        raise ValueError(f"unknown wire dtype: {mode!r}")
    q, scale = _int8_levels_and_scale(x, block, draw)
    return {"q": q.to(torch.int8).contiguous(), "scale": scale.contiguous()}


def wire_draws(cfg, step, d: int, parts: int):
    """The step's stochastic-rounding draws, (parts, d), or None under
    nearest rounding. ``step``: the step's int32 tensor on the rows'
    device."""
    if getattr(cfg, "shadow_round", "nearest") != "stochastic":
        return None
    if step is None:
        raise ValueError("shadow_round='stochastic' needs the step: its "
                         "draws are fold_in(key(seed + 17), step)")
    return draws.round_draw(step, cfg.seed + draws.WIRE_SALT, d,
                            cfg.wire_dtype, parts)


def widen_wire_rows(buf: dict, mode: str,
                    block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Narrow buffers -> the f32 rows: the bf16 value, or level × its
    block's scale (one f32 multiply, as the decode kernels do it)."""
    return widen_wire_cols(buf, mode, block, 0, buf["q"].shape[-1])


def widen_wire_cols(buf: dict, mode: str, block: int, a: int,
                    b: int) -> torch.Tensor:
    """Columns [a, b) of the widened rows (``widen_wire_rows``), the scale
    of each column its absolute block's: any cut, ``a`` need not lie on a
    block."""
    q = buf["q"][..., a:b]
    if mode == "bf16":
        return q.float()
    if mode != "int8":
        raise ValueError(f"unknown wire dtype: {mode!r}")
    block = max(int(block), 1)
    lo = a // block
    wide = buf["scale"][..., lo:-(-b // block)].repeat_interleave(
        block, dim=-1)[..., a - lo * block:b - lo * block]
    return q.float() * wide


def wire_decode_params(cfg, n=None, s=None):
    """(rel_tol, lam) of the cyclic decode at ``cfg``'s wire dtype:
    (None, 0.0) on the f32 wire, where the caller keeps HEALTH_REL_TOL and
    the exact λ = 0 solve; else the table's threshold at (num_workers,
    worker_fail) — or at (``n``, ``s``), the tree's group shape (fan-in,
    s_g) — and the dtype's locator λ."""
    if cfg.wire_dtype == "f32":
        return None, 0.0
    n = cfg.num_workers if n is None else n
    s = cfg.worker_fail if s is None else s
    return (wire_rel_tol(n, s, cfg.wire_dtype),
            wire_locator_lambda(cfg.wire_dtype))


def narrow_wire_pair(cfg, enc_re: torch.Tensor, enc_im: torch.Tensor,
                     step=None):
    """The narrow wire on a cyclic codeword pair: returns ``(enc_re, enc_im,
    wire)`` with the pair widened back to f32 (the projection and the
    locator read it) and ``wire = (mode, buf_re, buf_im, block)`` for the
    narrow recombination; the pair unchanged and ``wire = None`` on the f32
    wire. ``step``: the step's device tensor, for stochastic rounding (the
    imaginary part draws from ``fold_in(key, 1)``)."""
    if cfg.wire_dtype == "f32":
        return enc_re, enc_im, None
    mode, block = cfg.wire_dtype, int(cfg.shadow_block)
    r = wire_draws(cfg, step, enc_re.shape[-1], 2)
    buf_re = narrow_wire_rows(enc_re, mode, block, None if r is None else r[0])
    buf_im = narrow_wire_rows(enc_im, mode, block, None if r is None else r[1])
    return (widen_wire_rows(buf_re, mode, block),
            widen_wire_rows(buf_im, mode, block),
            (mode, buf_re, buf_im, block))


def narrow_wire_single(cfg, rows: torch.Tensor, step=None):
    """The narrow wire on one block of rows (the approx partial sums, the
    vote's gradient rows): ``wire = (mode, buf, block)``, or None on the
    f32 wire. Unlike the reference it returns no widened copy: the approx
    decode reads the narrow buffers (the kernel widens in registers, its
    plain version in its own body), so the widened (n, d) matrix is never
    written; the vote widens them itself (``widen_wire_rows``)."""
    if cfg.wire_dtype == "f32":
        return None
    block = int(cfg.shadow_block)
    r = wire_draws(cfg, step, rows.shape[-1], 1)
    return (cfg.wire_dtype, narrow_wire_rows(rows, cfg.wire_dtype, block,
                                             None if r is None else r[0]),
            block)


# the segmented wire's cut quantum (the reference's ops/coded.TILE_D, kept
# a literal there too): interior cuts land on multiples of it
SEGMENT_QUANTUM = 4096


def wire_segment_bounds(d: int, segments: int, block: int = 1) -> tuple:
    """The segmented wire's cuts ``(0 = b_0 < b_1 < ... < b_S = d)``: the d
    axis in at most ``segments`` pieces, every interior cut a multiple of
    the quantum (SEGMENT_QUANTUM when ``block`` divides it, else ``block``
    itself), so an int8 scale block never straddles a cut. A d of fewer
    than ``segments`` quanta gives fewer (possibly one) segments, never a
    sliver below the quantum. The reference's cuts, verbatim."""
    d = int(d)
    segments = max(int(segments), 1)
    block = max(int(block), 1)
    if d <= 0:
        return (0, 0)
    quantum = SEGMENT_QUANTUM if SEGMENT_QUANTUM % block == 0 else block
    units = -(-d // quantum)  # whole quanta covering d
    s_eff = max(min(segments, units), 1)
    per, rem = divmod(units, s_eff)
    bounds = [0]
    for i in range(s_eff):
        step = (per + (1 if i < rem else 0)) * quantum
        bounds.append(min(bounds[-1] + step, d))
    bounds[-1] = d
    # clamping can only collapse trailing cuts onto d
    out = [bounds[0]]
    for b in bounds[1:]:
        if b > out[-1]:
            out.append(b)
    return tuple(out)


def cfg_segment_bounds(cfg, dim: int) -> tuple:
    """The segment cuts ``cfg`` induces at flat-gradient size ``dim``: an
    int8 wire aligns them to its scale block, f32 and bf16 to the quantum
    alone."""
    block = (int(getattr(cfg, "shadow_block", DEFAULT_BLOCK))
             if getattr(cfg, "wire_dtype", "f32") == "int8" else 1)
    return wire_segment_bounds(dim, getattr(cfg, "wire_segments", 1),
                               block)


# --------------------------------------------------------------------------
# the observatory's schema
# --------------------------------------------------------------------------


def watch_enabled(cfg) -> bool:
    """True when the step computes any observatory column."""
    return cfg.numerics_watch == "on" or cfg.shadow_wire != "off"


def numerics_metric_names() -> tuple:
    """The numerics columns: 3 stages × STAT_NAMES."""
    return tuple(f"{NUMERICS_PREFIX}{stage}_{stat}"
                 for stage in NUMERICS_STAGES for stat in STAT_NAMES)


def watch_metric_names(cfg) -> tuple:
    """The observatory's columns of ``cfg``'s metric schema."""
    names = ()
    if cfg.numerics_watch == "on":
        names += numerics_metric_names()
    if cfg.shadow_wire != "off":
        names += SHADOW_NAMES
    return names


# --------------------------------------------------------------------------
# the wire ledger
# --------------------------------------------------------------------------


def wire_rows(approach: str) -> int:
    """Rows a worker ships a gradient element: the cyclic code's re + im
    pair, one row otherwise."""
    return 2 if approach == "cyclic" else 1


def _segment_bytes(bounds: tuple, rows: int, dtype: str,
                   block: int) -> list:
    """A worker's wire bytes of each segment [a, b) at ``dtype``."""
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        w = rows * (b - a)
        if dtype == "f32":
            out.append(4 * w)
        elif dtype == "bf16":
            out.append(2 * w)
        else:  # int8: a byte an element and an f32 scale a block
            out.append(w + 4 * rows * (-(-(b - a) // block)))
    return out


def wire_ledger(cfg, dim: int) -> dict:
    """A step's worker -> aggregator wire bytes at flat-gradient size
    ``dim``: every dtype's, the wire's own (``physical_*``), a segment's,
    and the tree's per-level ingest (the reference's dict)."""
    n = int(cfg.num_workers)
    rows = wire_rows(cfg.approach)
    words = rows * int(dim)
    block = max(int(getattr(cfg, "shadow_block", DEFAULT_BLOCK)), 1)
    blocks = rows * ((int(dim) + block - 1) // block)
    per_worker = {"f32": 4 * words, "bf16": 2 * words,
                  "int8": words + 4 * blocks}
    wire_dtype = getattr(cfg, "wire_dtype", "f32")
    bounds = cfg_segment_bounds(cfg, dim)
    seg_worker = _segment_bytes(bounds, rows, wire_dtype, block)
    ledger = {
        "family": cfg.approach,
        "dim": int(dim),
        "num_workers": n,
        "wire_words_per_worker": words,
        "bytes_per_worker": per_worker,
        "bytes_per_step": {k: v * n for k, v in per_worker.items()},
        "wire_dtype": wire_dtype,
        "physical_bytes_per_worker": per_worker[wire_dtype],
        "physical_bytes_per_step": per_worker[wire_dtype] * n,
        "shadow_wire": cfg.shadow_wire,
        "shadow_block": block,
        "segments": {
            "count": len(bounds) - 1,
            "bounds": list(bounds),
            "physical_bytes_per_worker": seg_worker,
            "physical_bytes_per_step": [v * n for v in seg_worker],
        },
    }
    if getattr(cfg, "topology", "flat") == "tree":
        from draco_tpu_torch.coding.topology import tree_ledger_block

        ledger["tree"] = tree_ledger_block(
            n, int(cfg.tree_fanout), int(getattr(cfg, "tree_levels", 0)),
            int(dim), per_worker[wire_dtype])
    return ledger


# --------------------------------------------------------------------------
# the numerics columns
# --------------------------------------------------------------------------


def stage_columns(stage: str, parts, block: int = DEFAULT_BLOCK) -> dict:
    """The ``nx_{stage}_*`` columns over ``parts`` (the cyclic wire is its
    re, im pair), 0-d float32 on the parts' device (``stage_stats``)."""
    from draco_tpu_torch.ops import numerics as numerics_ops

    cols = numerics_ops.stage_stats(
        [p.float().contiguous() for p in parts], block)
    return {f"{NUMERICS_PREFIX}{stage}_{name}": cols[i]
            for i, name in enumerate(STAT_NAMES)}


def numerics_columns(cfg, grad_parts, wire_parts, agg) -> dict:
    """The three stages' columns (``numerics_metric_names`` order)."""
    block = max(int(cfg.shadow_block), 1)
    cols = stage_columns("grad", list(grad_parts), block)
    cols.update(stage_columns("wire", list(wire_parts), block))
    cols.update(stage_columns("agg", [agg], block))
    return cols


# --------------------------------------------------------------------------
# the shadow-quantized wire
# --------------------------------------------------------------------------


def shadow_draws(cfg, step, d: int, parts: int):
    """The shadow's stochastic-rounding draws (parts, d) at seed + 11, or
    None under nearest rounding."""
    if cfg.shadow_round != "stochastic":
        return None
    return draws.round_draw(step, cfg.seed + draws.SHADOW_SALT, d,
                            cfg.shadow_wire, parts)


def quantize_rows(x: torch.Tensor, mode: str, block: int = DEFAULT_BLOCK,
                  draw=None) -> torch.Tensor:
    """Wire rows rounded to ``mode`` and widened back: the f32 rows the
    shadow decode reads, through the real wire's cores
    (``narrow_wire_rows`` for bf16; ``_int8_levels_and_scale`` for int8,
    its levels kept in f32 as the reference keeps them, so a level of −0
    gives −0; ``widen_wire_rows``)."""
    block = max(int(block), 1)
    if mode == "int8":
        q, scale = _int8_levels_and_scale(x.float(), block, draw)
        return widen_wire_rows({"q": q, "scale": scale}, mode, block)
    return widen_wire_rows(narrow_wire_rows(x, mode, block, draw), mode,
                           block)


def _finite_or(v: torch.Tensor,
               sentinel: float = SHADOW_SENTINEL) -> torch.Tensor:
    v = v.to(torch.float32)
    return torch.where(torch.isfinite(v), v, torch.full_like(v, sentinel))


def shadow_columns(agg, shadow_agg, shadow_residual, flags, shadow_flags,
                   adv_mask, present=None) -> dict:
    """The SHADOW_NAMES columns of one step's f32 and shadow decodes; the
    shadow flag set scored among the present rows."""
    n = flags.shape[0]
    pres = (torch.ones((n,), dtype=torch.bool, device=flags.device)
            if present is None else present.to(torch.bool))
    f = flags.to(torch.bool) & pres
    sf = shadow_flags.to(torch.bool) & pres
    adv = adv_mask.to(torch.bool)
    agg, shadow_agg = agg.float(), shadow_agg.float()
    err = torch.sqrt(((shadow_agg - agg) ** 2).sum()) / torch.clamp_min(
        torch.sqrt((agg ** 2).sum()), 1e-30)
    agree = ((f == sf) & pres).to(torch.float32).sum() / torch.clamp_min(
        pres.to(torch.float32).sum(), 1.0)
    return {
        "shadow_err": _finite_or(err),
        "shadow_residual": _finite_or(shadow_residual),
        "shadow_flag_agree": _finite_or(agree),
        "shadow_det_flagged": sf.to(torch.int32).sum(),
        "shadow_det_tp": (sf & adv & pres).to(torch.int32).sum(),
    }


def cyclic_shadow(cfg, code, enc_re, enc_im, agg, flags, rand_factor,
                  leaf_offsets, present, adv_mask, step=None) -> dict:
    """The cyclic shadow: both halves rounded (the imaginary half's draw
    from ``fold_in(key, 1)``), decoded at SHADOW_REL_TOL at the f32
    decode's granularity (global, or a locator a leaf)."""
    from draco_tpu_torch.coding import cyclic as cyclic_mod

    mode, block = cfg.shadow_wire, int(cfg.shadow_block)
    r = shadow_draws(cfg, step, enc_re.shape[-1], 2)
    q_re = quantize_rows(enc_re, mode, block, None if r is None else r[0])
    q_im = quantize_rows(enc_im, mode, block, None if r is None else r[1])
    rel_tol = SHADOW_REL_TOL[mode]
    if cfg.decode_granularity == "layer":
        sagg, _, sh = cyclic_mod.decode_layers(
            code, q_re, q_im, rand_factor, leaf_offsets, present=present,
            with_health=True, rel_tol=rel_tol)
    else:
        sagg, _, sh = cyclic_mod.decode(
            code, q_re, q_im, rand_factor, present=present,
            with_health=True, rel_tol=rel_tol)
    return shadow_columns(agg, sagg, sh["residual"], flags, sh["flagged"],
                          adv_mask, present)


def majvote_shadow(cfg, rep_code, grads, voted, flags, salts, present,
                   adv_mask, step=None) -> dict:
    """The vote's shadow: the gradient rows (this family's wire) rounded
    with one draw for every row, voted again with the step's salts; the
    residual is 1 − the shadow's vote agreement."""
    from draco_tpu_torch.coding import repetition as rep_mod

    r = shadow_draws(cfg, step, grads.shape[-1], 1)
    qg = quantize_rows(grads, cfg.shadow_wire, cfg.shadow_block,
                       None if r is None else r[0])
    voted_s, sh = rep_mod.majority_vote(rep_code, qg, present, salts,
                                        cfg.vote_check, with_health=True)
    return shadow_columns(voted, voted_s, 1.0 - sh["vote_agree"], flags,
                          sh["flagged"], adv_mask, present)


def approx_shadow(cfg, code, rows, grads, decoded, vn_pres, present,
                  adv_mask, step=None) -> dict:
    """The approx code's shadow: the partial-sum rows rounded and decoded
    with the step's weights (``vn_pres``); the flags are the non-finite
    wire rows (this code has no located set), the residual the shadow
    decode's relative error."""
    from draco_tpu_torch.coding import approx as approx_mod
    from draco_tpu_torch.ops.numerics import nonfinite_rows

    r = shadow_draws(cfg, step, rows.shape[-1], 1)
    q = quantize_rows(rows, cfg.shadow_wire, cfg.shadow_block,
                      None if r is None else r[0])
    dec_s, residual = approx_mod.decode_device(code, q, grads, vn_pres)
    return shadow_columns(decoded, dec_s, residual, nonfinite_rows(rows),
                          nonfinite_rows(q), adv_mask, present)
