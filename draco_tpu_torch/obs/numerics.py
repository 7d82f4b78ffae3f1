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
``tests/test_torch_draws.py``). The reference's numerics observatory,
shadow decode and wire ledger are not ported; of its shadow quantizer only
the key function (``shadow_step_key``) is.

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

# per-dtype threshold band for shapes outside the table, at s ≤ 2
SHADOW_REL_TOL = {"bf16": 5e-2, "int8": 1.5e-1}


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
