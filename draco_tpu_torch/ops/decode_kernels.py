"""The fused decode kernels (draco_tpu/ops/decode_kernels.py).

``cyclic_locator`` runs decode steps 2–5 and the decode health on a stack
of projected columns: syndrome → Hankel solve by one-sided Jacobi →
locator on the DFT grid → top-(n−2s) honest mask → one complex
Gauss–Jordan inverse giving the recombination vector and the codeword fit
→ flagged / loud / residual. Kernel: ``csrc/cyclic_locator.cu`` (one
warp a column, the chain spread over its lanes); plain version:
``coding/cyclic.locator_core``.

``cyclic_narrow_recombine`` is the cyclic recombination Re(vᵀR) read from
the narrow wire (bf16, or int8 levels with per-block scales), widened in
registers. ``approx_decode`` is the approx code's decode tail in one pass
over d: the absent rows zero-filled, Σ (v/n)·rows, the true mean of the
batch gradients, and the two squared norms of the residual certificate.
Kernels: ``csrc/narrow_decode.cu``; plain versions: ``*_plain`` here.

The segmented wire's entries: ``cyclic_narrow_recombine_segments`` (every
segment of a ``ops.coded.SegmentPlan`` in one launch, each with its own v
pair) and ``approx_decode_segment`` (the approx decode on columns [a, b) of
the whole buffers, read in place: the kernel's offset entry). Both index
int8 scales by the absolute column, so any cut works, a layer boundary
inside a scale block included. The reference's views of a segment
(``wire_slice_pair``, ``wire_slice_single``) slice a narrow buffer; they
keep its rule that an int8 cut lie on a scale block.

Each wrapper launches its kernel on CUDA tensors and runs its plain
version on CPU tensors; any other device raises. It counts its kernel
launches in ``<wrapper>.launches``. The launch itself (``*_launch``) writes
into outputs the caller allocated (the kernel audit hands it guarded
buffers).
"""

from __future__ import annotations

from typing import Optional

import torch

from draco_tpu_torch import _build
from draco_tpu_torch.obs import numerics
from draco_tpu_torch.ops import coded

MAX_N = 64  # the locator's two rows a lane; rank counts are exact to 64 rows
# wire element type -> the narrow_decode kernels' template switch
WIRE_CODES = {"f32": 0, "bf16": 1, "int8": 2}
WIRE_TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                     "int8": torch.int8}


def resolve_decode_impl(value: str, device) -> str:
    """cfg.decode_impl -> which locator runs on ``device``: ``"cuda"`` (the
    kernel) for a CUDA device, ``"plain"`` (``locator_core``) for the CPU.
    ``auto`` and ``pallas`` mean the same here: the kernel wherever it can
    run. There is no fallback from the kernel on a CUDA device."""
    if value not in ("auto", "pallas"):
        raise ValueError(f"decode_impl must be auto|pallas, got {value!r}")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return "cuda" if dev.type == "cuda" else "plain"


def cyclic_locator(code, e_re_l, e_im_l, pres_f, rel_tol: float,
                   lam: float = 0.0):
    """(L, n) projected-column stack -> ``(v_re, v_im, honest, flagged,
    loud, residual)`` of :func:`~draco_tpu_torch.coding.cyclic.locator_core`:
    the first five (L, n), ``residual`` (L,). ``pres_f``: f32 presence,
    (1, n) shared by every column or (L, n) a row a column (the tree
    topology's groups: each column its own group's arrivals)."""
    dev = e_re_l.device
    if resolve_decode_impl("auto", dev) == "plain":
        from draco_tpu_torch.coding import cyclic as cyclic_mod

        t = code.tensors(dev)
        return cyclic_mod.locator_core(
            e_re_l, e_im_l, t["c2h_re"], t["c2h_im"], t["c1_re"], t["c1_im"],
            t["est_re"], t["est_im"], pres_f, code.s, rel_tol, lam=lam)
    L, n = e_re_l.shape
    if n != code.n or n > MAX_N:
        raise ValueError(f"cyclic_locator: columns of {n} rows for a code of "
                         f"n={code.n} (the kernel takes n <= {MAX_N})")
    for x in (e_re_l, e_im_l, pres_f):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("cyclic_locator takes contiguous float32 tensors "
                             f"on one device; got {x.dtype} on {x.device}")
    if e_im_l.shape != (L, n) or pres_f.shape not in ((1, n), (L, n)):
        raise ValueError(f"cyclic_locator: e {tuple(e_re_l.shape)} / "
                         f"{tuple(e_im_l.shape)}, pres {tuple(pres_f.shape)}")
    v_re, v_im = torch.empty((2, L, n), dtype=torch.float32,
                             device=dev).unbind(0)
    honest, flagged, loud = torch.empty((3, L, n), dtype=torch.bool,
                                        device=dev).unbind(0)
    resid = torch.empty((L,), dtype=torch.float32, device=dev)
    cyclic_locator_launch(code, e_re_l, e_im_l, pres_f, rel_tol, lam, v_re,
                          v_im, honest, flagged, loud, resid)
    cyclic_locator.launches += 1
    return v_re, v_im, honest, flagged, loud, resid


# the locator kernel's dispatch table, ``kRoutes`` of csrc/cyclic_locator.cu
# (a CPU test holds the two equal): (n_lo, n_hi, s_lo, s_hi, instance) —
# one or two rows a lane (n <= 32, n <= 64), the Hankel solve in registers
# at s = 1 and s = 2, else in a shared tile
LOCATOR_ROUTES = (
    (1, 32, 0, 0, "kRow1"),
    (1, 32, 1, 1, "kRow1M2"),
    (1, 32, 2, 2, "kRow1M4"),
    (1, 32, 3, 15, "kRow1"),
    (33, 64, 0, 15, "kRow2"),
)


def locator_instance(n: int, s: int) -> str:
    """The ``__global__`` instance the locator launches at (n, s)."""
    for n_lo, n_hi, s_lo, s_hi, v in LOCATOR_ROUTES:
        if n_lo <= n <= n_hi and s_lo <= s <= s_hi:
            return f"cyclic_locator_kernel<{v}>"
    raise ValueError(f"cyclic_locator: no kernel instance for n={n}, s={s}")


def _locator_context(code, dev) -> tuple:
    """``(fn, constants, sweeps, rcond², loud tolerance, φ)`` of one code on
    one CUDA device: the launcher and the arguments that do not change from
    call to call (the pointers of the code's six constants, which live as
    long as the code), cached on the code beside its tensors."""
    cache = code.__dict__.setdefault("_locator_ctx", {})
    ctx = cache.get(dev)
    if ctx is None:
        from draco_tpu_torch.coding import cyclic as cyclic_mod

        t = code.tensors(dev)
        ctx = (_build.library("cyclic_locator").draco_cyclic_locator,
               tuple(t[k].data_ptr() for k in ("c2h_re", "c2h_im", "c1_re",
                                               "c1_im", "est_re", "est_im")),
               cyclic_mod.linalg_mod.JACOBI_SWEEPS,
               cyclic_mod.LOCATOR_RCOND ** 2, cyclic_mod.LOUD_REL_TOL,
               cyclic_mod.SPREAD_PHI)
        cache[dev] = ctx
    return ctx


def cyclic_locator_launch(code, e_re_l, e_im_l, pres_f, rel_tol, lam, v_re,
                          v_im, honest, flagged, loud, resid) -> None:
    """The locator kernel into ``v_re``, ``v_im`` (L, n) f32, the one-byte
    masks ``honest``, ``flagged``, ``loud`` (L, n) and ``resid`` (L,)."""
    dev = e_re_l.device
    L, n = e_re_l.shape
    fn, consts, sweeps, rcond2, loud_tol, phi = _locator_context(code, dev)
    err = fn(e_re_l.data_ptr(), e_im_l.data_ptr(), *consts,
             pres_f.data_ptr(), v_re.data_ptr(), v_im.data_ptr(),
             honest.data_ptr(), flagged.data_ptr(), loud.data_ptr(),
             resid.data_ptr(), L, n, code.s,
             # the presence's row stride: 0 shared, n a row a column
             0 if pres_f.shape[0] == 1 else n, sweeps, rcond2, lam, lam * lam,
             2.0 * lam, 1e-3 / n, rel_tol ** 2, loud_tol, phi,
             torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(err, "cyclic_locator")


cyclic_locator.launches = 0


# --------------------------------------------------------------------------
# decodes that read the wire as it arrived (csrc/narrow_decode.cu)
# --------------------------------------------------------------------------

def narrow_kernel_ok(wire) -> bool:
    """Whether the narrow-wire kernels take ``wire``: any bf16 wire, and an
    int8 wire of any scale block ≥ 1. (The reference also needs the block
    to divide its TILE_D, a tiling limit of the TPU the port's kernels do
    not have, so on a narrow wire the port always takes them.)"""
    return wire is not None and (wire[0] == "bf16" or int(wire[-1]) >= 1)


def _on_cuda(*tensors) -> bool:
    """True for CUDA inputs (contiguous, one device), False for CPU ones."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"decode kernels run on cuda or cpu tensors, got "
                         f"{dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"decode kernels take contiguous tensors on one device; got "
                f"{tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    return True


def _wire_operands(mode: str, buf: dict, block: int, n: int, d: int,
                   what: str):
    """The kernel's view of one narrow buffer: ``(q, scale or None, block,
    nb)``, checked against (n, d)."""
    q, scale = buf["q"], buf.get("scale")
    if mode not in WIRE_CODES or q.dtype != WIRE_TORCH_DTYPES[mode] \
            or q.shape != (n, d):
        raise ValueError(f"{what}: a {mode} wire of {q.dtype} "
                         f"{tuple(q.shape)}, expected ({n}, {d})")
    if mode != "int8":
        return q, None, 1, 0
    nb = -(-d // block) if block >= 1 else -1
    if block < 1 or scale is None or scale.dtype != torch.float32 \
            or scale.shape != (n, nb):
        raise ValueError(f"{what}: int8 scales "
                         f"{None if scale is None else tuple(scale.shape)} "
                         f"at block {block}, expected ({n}, {nb}) float32")
    return q, scale, block, nb


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _f32_vectors(what: str, n: int, *vs) -> None:
    for v in vs:
        if v.dtype != torch.float32 or v.shape != (n,):
            raise ValueError(f"{what}: a vector of {v.dtype} "
                             f"{tuple(v.shape)}, expected ({n},) float32")


def cyclic_narrow_recombine_plain(v_re, v_im, wire):
    """Re[(vr + i·vi)ᵀ (R_re + i·R_im)] with R the widened wire buffers:
    two sums, then their difference, as the reference's kernel body."""
    mode, buf_re, buf_im, block = wire
    return (v_re @ numerics.widen_wire_rows(buf_re, mode, block)
            - v_im @ numerics.widen_wire_rows(buf_im, mode, block))


def cyclic_narrow_recombine(v_re, v_im, wire):
    """The cyclic recombination from the narrow wire ``(mode, buf_re,
    buf_im, block)`` of ``obs.numerics.narrow_wire_pair``: v (n,) f32 ->
    (d,) f32. The kernel reads the bf16 / int8 buffers once and widens in
    registers, so the widened (n, d) pair is not read again."""
    mode, buf_re, buf_im, block = wire
    tensors = [v_re, v_im, buf_re["q"], buf_im["q"]] + [
        b["scale"] for b in (buf_re, buf_im) if "scale" in b]
    if not _on_cuda(*tensors):
        return cyclic_narrow_recombine_plain(v_re, v_im, wire)
    n, d = buf_re["q"].shape
    if n > MAX_N:
        raise ValueError(f"cyclic_narrow_recombine: n={n} > {MAX_N}")
    _f32_vectors("cyclic_narrow_recombine", n, v_re, v_im)
    q_re, s_re, blk, nb = _wire_operands(mode, buf_re, int(block), n, d,
                                         "cyclic_narrow_recombine")
    q_im, s_im, _, _ = _wire_operands(mode, buf_im, int(block), n, d,
                                      "cyclic_narrow_recombine")
    out = torch.empty((d,), dtype=torch.float32, device=q_re.device)
    narrow_recombine_launch(v_re, v_im, mode, q_re, s_re, q_im, s_im, blk,
                            nb, out)
    cyclic_narrow_recombine.launches += 1
    return out


def narrow_recombine_launch(v_re, v_im, mode, q_re, s_re, q_im, s_im, block,
                            nb, out) -> None:
    """The narrow recombination kernel on checked wire operands (``mode``
    f32, bf16 or int8; scales None but for int8) into ``out`` (d,)."""
    n, d = q_re.shape
    err = _build.library("narrow_decode").draco_narrow_recombine(
        v_re.data_ptr(), v_im.data_ptr(), q_re.data_ptr(), q_im.data_ptr(),
        _ptr(s_re), _ptr(s_im), out.data_ptr(), n, d, WIRE_CODES[mode],
        block, nb, torch.cuda.current_stream(q_re.device).cuda_stream)
    _build.check(err, "cyclic_narrow_recombine")


cyclic_narrow_recombine.launches = 0


def approx_decode_plain(rows, batch_grads, v_over_n, pres_f, wire=None):
    """The approx decode tail: rows of absent workers (``pres_f`` 0)
    zero-filled by where-select (a NaN payload must not survive), decoded
    Σ (v/n)_i·row_i, true mean Σ (1/n)·bg_i, and Σ(decoded − mean)², Σ bg².
    With ``wire = (mode, buf, block)`` the rows are the widened buffers."""
    if wire is not None:
        rows = numerics.widen_wire_rows(wire[1], wire[0], wire[2])
    n = batch_grads.shape[0]
    rows = torch.where(pres_f[:, None] > 0, rows, torch.zeros_like(rows))
    decoded = v_over_n @ rows
    mean = torch.full((n,), 1.0 / n, dtype=torch.float32,
                      device=batch_grads.device) @ batch_grads
    return (decoded, ((decoded - mean) ** 2).sum(),
            (batch_grads * batch_grads).sum())


def approx_decode(rows, batch_grads, v_over_n, pres_f, wire=None):
    """The approx decode tail in one pass over d (``approx_decode_plain``):
    ``rows`` (n, d) f32, or None with ``wire = (mode, buf, block)`` of
    ``obs.numerics.narrow_wire_single`` (the kernel reads the bf16 / int8
    buffers and widens in registers); ``batch_grads`` (n, d) f32,
    ``v_over_n`` and ``pres_f`` (n,) f32. Returns ``(decoded (d,),
    Σ(decoded − mean)², Σ bg²)``, the last two 0-d."""
    mode, buf, block = ("f32", {"q": rows}, 1) if wire is None else wire
    tensors = [buf["q"], batch_grads, v_over_n, pres_f] + (
        [buf["scale"]] if "scale" in buf else [])
    if not _on_cuda(*tensors):
        return approx_decode_plain(rows, batch_grads, v_over_n, pres_f, wire)
    n, d = batch_grads.shape
    if n > MAX_N or batch_grads.dtype != torch.float32:
        raise ValueError(
            f"approx_decode: batch gradients {batch_grads.dtype} "
            f"{tuple(batch_grads.shape)} (float32, n <= {MAX_N})")
    _f32_vectors("approx_decode", n, v_over_n, pres_f)
    q, scale, blk, nb = _wire_operands(mode, buf, int(block), n, d,
                                       "approx_decode")
    chunks = approx_decode_chunks(d)
    dev = q.device
    decoded = torch.empty((d,), dtype=torch.float32, device=dev)
    part = torch.empty((2, chunks), dtype=torch.float32, device=dev)
    sums = torch.empty((2,), dtype=torch.float32, device=dev)
    approx_decode_launch(mode, q, scale, blk, nb, batch_grads, v_over_n,
                         pres_f, decoded, part, sums)
    approx_decode.launches += 1
    return decoded, sums[0], sums[1]


def approx_decode_chunks(d: int) -> int:
    """Pass-1 blocks of the approx decode at length d: its (2, chunks)
    partials."""
    return _build.library("narrow_decode").draco_approx_decode_chunks(d)


def approx_decode_launch(mode, q, scale, block, nb, batch_grads, v_over_n,
                         pres_f, decoded, part, sums, a: int = 0,
                         b: Optional[int] = None) -> None:
    """Both passes of the approx decode on checked wire operands into
    ``decoded`` (d,), the partials ``part`` (2, chunks) and ``sums``
    (2,). With ``a``, ``b``: on columns [a, b) of the (n, d) ``q`` and
    ``batch_grads`` (the offset entry), ``decoded`` then (b − a,)."""
    n, ld = batch_grads.shape
    b = ld if b is None else b
    err = _build.library("narrow_decode").draco_approx_decode(
        q.data_ptr() + a * q.element_size(), _ptr(scale),
        batch_grads.data_ptr() + 4 * a, v_over_n.data_ptr(),
        pres_f.data_ptr(), decoded.data_ptr(), part.data_ptr(),
        sums.data_ptr(), n, b - a, ld, a, WIRE_CODES[mode], block, nb,
        part.shape[1], 1.0 / n,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "approx_decode")


approx_decode.launches = 0



# --------------------------------------------------------------------------
# the segmented wire: segment views and the segment entries
# --------------------------------------------------------------------------

def _slice_narrow_buf(buf: dict, a: int, b: int, block) -> dict:
    """Columns [a, b) of one narrow buffer ``{"q"[, "scale"]}``: the int8
    scale columns slice at block granularity, so an int8 cut must lie on a
    scale block (the reference's rule; ``obs.numerics.wire_segment_bounds``
    cuts there)."""
    out = {"q": buf["q"][:, a:b]}
    if "scale" in buf:
        blk = max(int(block), 1)
        if a % blk:
            raise ValueError(
                f"segment cut {a} not aligned to int8 scale block {blk}")
        out["scale"] = buf["scale"][:, a // blk:-(-b // blk)]
    return out


def wire_slice_pair(wire, a: int, b: int):
    """The [a, b) view of a ``narrow_wire_pair`` wire ``(mode, buf_re,
    buf_im, block)``: the same tuple over sliced buffers."""
    if wire is None:
        return None
    mode, buf_re, buf_im, block = wire
    return (mode, _slice_narrow_buf(buf_re, a, b, block),
            _slice_narrow_buf(buf_im, a, b, block), block)


def wire_slice_single(wire, a: int, b: int):
    """The [a, b) view of a ``narrow_wire_single`` wire ``(mode, buf,
    block)``."""
    if wire is None:
        return None
    mode, buf, block = wire
    return (mode, _slice_narrow_buf(buf, a, b, block), block)


def cyclic_narrow_recombine_segments_plain(v_re, v_im, wire, plan):
    """One narrow recombination a segment into one (d,) output: columns
    [a_j, b_j) widened (level × its absolute block's scale) and summed with
    segment j's v pair."""
    mode, buf_re, buf_im, block = wire
    out = torch.zeros((buf_re["q"].shape[1],), dtype=torch.float32,
                      device=buf_re["q"].device)
    for j, (a, b) in enumerate(zip(plan.bounds[:-1], plan.bounds[1:])):
        out[a:b] = (v_re[j] @ numerics.widen_wire_cols(buf_re, mode, block,
                                                       a, b)
                    - v_im[j] @ numerics.widen_wire_cols(buf_im, mode, block,
                                                         a, b))
    return out


def cyclic_narrow_recombine_segments(v_re, v_im, wire, plan):
    """The cyclic recombination from the narrow wire ``(mode, buf_re,
    buf_im, block)`` over every segment of ``plan`` (``ops.coded
    .segment_plan``): v (S, n) f32 -> (d,) f32, segment j's columns with
    v[j]. One launch; the buffers are read in place at any cut."""
    mode, buf_re, buf_im, block = wire
    tensors = [v_re, v_im, buf_re["q"], buf_im["q"]] + [
        b["scale"] for b in (buf_re, buf_im) if "scale" in b]
    if not _on_cuda(*tensors):
        return cyclic_narrow_recombine_segments_plain(v_re, v_im, wire, plan)
    n, d = buf_re["q"].shape
    what = "cyclic_narrow_recombine_segments"
    if n > MAX_N or mode not in ("bf16", "int8"):
        raise ValueError(f"{what}: n={n} (<= {MAX_N}), a {mode} wire "
                         f"(bf16 or int8)")
    for v in (v_re, v_im):
        if v.dtype != torch.float32 or v.shape != (plan.segments, n):
            raise ValueError(f"{what}: v of {v.dtype} {tuple(v.shape)}, "
                             f"expected ({plan.segments}, {n}) float32")
    coded.check_plan(plan, d, buf_re["q"].device, what)
    q_re, s_re, blk, nb = _wire_operands(mode, buf_re, int(block), n, d, what)
    q_im, s_im, _, _ = _wire_operands(mode, buf_im, int(block), n, d, what)
    out = torch.empty((d,), dtype=torch.float32, device=q_re.device)
    narrow_recombine_segments_launch(v_re, v_im, mode, q_re, s_re, q_im,
                                     s_im, blk, nb, plan, out)
    cyclic_narrow_recombine_segments.launches += 1
    return out


def narrow_recombine_segments_launch(v_re, v_im, mode, q_re, s_re, q_im,
                                     s_im, block, nb, plan, out) -> None:
    """The segmented narrow recombination kernel on checked operands into
    ``out`` (d,)."""
    n, d = q_re.shape
    err = _build.library("narrow_decode").draco_narrow_recombine_segments(
        v_re.data_ptr(), v_im.data_ptr(), q_re.data_ptr(), q_im.data_ptr(),
        _ptr(s_re), _ptr(s_im), plan.table.data_ptr(), plan.tiles,
        out.data_ptr(), n, d, WIRE_CODES[mode], block, nb,
        torch.cuda.current_stream(q_re.device).cuda_stream)
    _build.check(err, "cyclic_narrow_recombine_segments")


cyclic_narrow_recombine_segments.launches = 0


def cyclic_narrow_recombine_segment(v_re, v_im, wire, a: int, b: int):
    """One segment's narrow recombination: the [a, b) slice of
    ``cyclic_narrow_recombine`` with this segment's v pair (n,), as the
    reference's entry — through the segmented kernel on a one-segment
    plan."""
    plan = coded.segment_plan((a, b), wire[1]["q"].device)
    return cyclic_narrow_recombine_segments(v_re[None], v_im[None], wire,
                                            plan)[a:b]


def approx_decode_segment(rows, batch_grads, v_over_n, pres_f, a: int,
                          b: int, wire=None, out=None):
    """The approx decode on columns [a, b) (the reference's
    ``approx_decode_segment``): ``rows`` / ``wire`` and ``batch_grads`` are
    the whole (n, d) operands, read in place (the kernel's offset entry; no
    copy). Writes the segment's decoded columns into ``out[a:b]`` (``out``
    (d,), allocated when None) and returns ``(out[a:b], Σ(decoded −
    mean)², Σ bg²)`` over the segment: the caller adds the sums across
    segments before the residual's square root."""
    mode, buf, block = ("f32", {"q": rows}, 1) if wire is None else wire
    tensors = [buf["q"], batch_grads, v_over_n, pres_f] + (
        [buf["scale"]] if "scale" in buf else [])
    n, d = batch_grads.shape
    if out is None:
        out = torch.empty((d,), dtype=torch.float32,
                          device=batch_grads.device)
    if not 0 <= a < b <= d:
        raise ValueError(f"approx_decode_segment: columns [{a}, {b}) of "
                         f"d={d}")
    if not _on_cuda(*tensors):
        seg = (rows[:, a:b] if wire is None
               else numerics.widen_wire_cols(buf, mode, block, a, b))
        dec, sd, sg = approx_decode_plain(seg, batch_grads[:, a:b],
                                          v_over_n, pres_f)
        out[a:b] = dec
        return out[a:b], sd, sg
    if n > MAX_N or batch_grads.dtype != torch.float32 \
            or out.shape != (d,) or not out.is_contiguous():
        raise ValueError(
            f"approx_decode_segment: batch gradients {batch_grads.dtype} "
            f"{tuple(batch_grads.shape)} (float32, n <= {MAX_N}), out "
            f"{tuple(out.shape)}")
    _f32_vectors("approx_decode_segment", n, v_over_n, pres_f)
    q, scale, blk, nb = _wire_operands(mode, buf, int(block), n, d,
                                       "approx_decode_segment")
    chunks = approx_decode_chunks(b - a)
    part = torch.empty((2, chunks), dtype=torch.float32, device=q.device)
    sums = torch.empty((2,), dtype=torch.float32, device=q.device)
    approx_decode_launch(mode, q, scale, blk, nb, batch_grads, v_over_n,
                         pres_f, out[a:b], part, sums, a, b)
    approx_decode_segment.launches += 1
    return out[a:b], sums[0], sums[1]


approx_decode_segment.launches = 0
