"""Shared tail of the flat-gradient steps (draco_tpu/parallel/common.py):
attack injection -> coded decode or robust aggregation -> optimizer update,
and the metric schema both the CNN step and the LM step emit.

The port's slice: the cyclic code (``simulate`` and ``shared``) with the
global or the layer-granularity decode, the approx code, each flat or on
the tree topology (``topology="tree"``, ``coding/topology.py``: shared
redundancy, global granularity), the f32 or the narrow bf16/int8 wire,
whole or in segments (``wire_segments``), stragglers as a presence mask,
and the baseline's seven robust rules (``aggregation.py``). The LM route
(``aggregate_flat_grads``) runs all of these but the repetition code,
which is the CNN step's alone (``training/step.py``). Both steps run the seeded fault plan's
in-step events on the per-worker gradients (``resilience/faults.py``)
before anything reads them, and end in the step guard
(``resilience/guards.py``): the update gated by the step's verdict.

The metric schema (``metric_family_names``, the one assembly of the CNN
step's ``metric_names`` and the LM's ``token_metric_names``): after a
route's base columns, its code's health columns, the packed forensics
masks (``obs/forensics.py``: the accused set — the code's flags ∪ its
loud rows ∪ the non-finite ingest rows, present-gated — the present set
and the adversary schedule), then the numerics observatory's columns
(``numerics_watch``, ``shadow_wire``; ``obs/numerics.py``), and last the
step guard's ``guard_trips, skipped_steps`` (``step_guard="on"``). The
baseline emits none of them but the guard's.

The cyclic decode's dispatch, one for both steps (``decode_bounds`` and
``cyclic_decode``): layer granularity — with segments the leaf boundaries
refined by the segment cuts (``segment_decode_bounds``), else the leaf
boundaries alone — then segments, then the global decode. With one
segment and global granularity the step never enters the segmented code.
"""

from __future__ import annotations

from typing import Optional

import torch

from draco_tpu_torch import aggregation, attacks
from draco_tpu_torch.coding import approx as approx_mod
from draco_tpu_torch.coding import cyclic as cyclic_mod
from draco_tpu_torch.coding import repetition
from draco_tpu_torch.coding import topology
from draco_tpu_torch.obs import forensics, numerics
from draco_tpu_torch.obs.tracer import phase
from draco_tpu_torch.resilience import faults, guards

# the LM's base columns; the optional families follow
# (metric_family_names)
TOKEN_METRIC_NAMES = ("loss",)

# per-step decode-health columns of the cyclic code:
#   decode_residual  self-consistency residual, ≈ 0 iff the decode is exact
#   located_errors   present rows the decode flagged as corrupt
#   det_tp           flagged ∧ adversarial ∧ present (true positives)
#   det_adv          adversarial ∧ present (the detectable ground truth)
DECODE_HEALTH_NAMES = ("decode_residual", "located_errors", "det_tp",
                       "det_adv")

# per-step health columns of the approx code (coding/approx.py):
#   decode_residual        measured relative decode error
#   decode_residual_bound  the arrived support's bound ‖u − 1‖₂
#   recovered_fraction     fraction of batches with a present worker
APPROX_HEALTH_NAMES = ("decode_residual", "decode_residual_bound",
                       "recovered_fraction")

# the repetition code's per-step health columns (coding/repetition.py)
# and its detection counts against the seeded schedules
VOTE_NAMES = ("vote_agree", "flagged_groups", "det_flagged", "det_tp",
              "det_adv")


def build_code_from_cfg(cfg):
    """The CyclicCode for approach="cyclic", the ApproxCode for "approx" —
    under ``topology="tree"`` the TreeCode of the one small group code —
    the RepetitionCode for "maj_vote", None for the baseline."""
    if cfg.approach in ("cyclic", "approx") and cfg.topology == "tree":
        return topology.build_tree_code(cfg)
    if cfg.approach == "maj_vote":
        return repetition.build_repetition_code(cfg.num_workers,
                                                cfg.group_size)
    if cfg.approach == "cyclic":
        return cyclic_mod.build_cyclic_code(cfg.num_workers, cfg.worker_fail)
    if cfg.approach == "approx":
        return approx_mod.build_approx_code(
            cfg.num_workers, cfg.code_redundancy, cfg.assignment_scheme)
    return None


def encode_shared(code, batch_grads: torch.Tensor):
    """The cyclic ``shared`` encode of the (n, d) batch gradients: the flat
    code's masked W, or the tree's block-diagonal one."""
    if topology.is_tree(code):
        return topology.encode_tree(code, batch_grads)
    return cyclic_mod.encode_shared(code, batch_grads)


def host_solve(code, present=None):
    """The approx decode's host half (``coding.approx.host_solve``), the
    tree's group by group (``coding.topology.host_solve``)."""
    if topology.is_tree(code):
        return topology.host_solve(code, present)
    return approx_mod.host_solve(code, present)


def cyclic_wire_params(cfg, code):
    """(rel_tol, lam) of the cyclic decode on ``cfg``'s wire: the flat
    code's at (n, s); the tree's at its group shape (fan-in, s_g), the shape
    each group decodes at (the reference's)."""
    tol, lam = (numerics.wire_decode_params(cfg, code.fanout, code.s)
                if topology.is_tree(code)
                else numerics.wire_decode_params(cfg))
    return (cyclic_mod.HEALTH_REL_TOL if tol is None else tol), lam


def segment_decode_bounds(cfg, dim: int, leaf_offsets=None) -> list:
    """The decode's partition on the segmented wire: the segment cuts
    (``obs.numerics.cfg_segment_bounds``), refined by the leaf boundaries
    when the decode runs at layer granularity, so every parameter tensor
    keeps its own locator."""
    bounds = list(numerics.cfg_segment_bounds(cfg, dim))
    if leaf_offsets is not None:
        cuts = sorted({int(o) for o in leaf_offsets}
                      | {int(b) for b in bounds})
        bounds = [c for c in cuts if 0 <= c <= dim]
    return bounds


def decode_bounds(cfg, dim: int, leaf_offsets=None) -> Optional[list]:
    """The cuts of the cyclic decode at ``cfg``: layer granularity — the
    leaf boundaries ``leaf_offsets``, refined by the segment cuts when
    ``wire_segments > 1`` — then the segment cuts; None for the global
    decode (one segment, global granularity)."""
    segments = int(cfg.wire_segments)
    if cfg.decode_granularity == "layer":
        if leaf_offsets is None:
            raise ValueError("decode_granularity='layer' needs the leaf "
                             "offsets (params.Layout.offsets)")
        if segments > 1:
            return segment_decode_bounds(cfg, dim, leaf_offsets)
        return [int(o) for o in leaf_offsets]
    if segments > 1:
        return list(numerics.cfg_segment_bounds(cfg, dim))
    return None


def cyclic_decode(cfg, code, enc_re, enc_im, rand_factor, bounds,
                  present: Optional[torch.Tensor] = None,
                  rel_tol: float = cyclic_mod.HEALTH_REL_TOL,
                  lam: float = 0.0, wire=None):
    """The cyclic decode ``cfg`` asks for over ``bounds``
    (:func:`decode_bounds`): ``(decoded (d,), honest (n,), health)``, the
    honest set and the health folded across segments. Layer granularity
    with one segment recombines the widened rows (the reference's
    ``decode_layers`` drops the narrow wire); with segments the narrow
    buffers are read at any cut. A tree code decodes group by group at
    once (``coding.topology.decode_tree_cyclic``, global granularity)."""
    if topology.is_tree(code):
        return topology.decode_tree_cyclic(code, enc_re, enc_im, rand_factor,
                                           present, rel_tol, lam, wire,
                                           bounds)
    if bounds is None:
        return cyclic_mod.decode(code, enc_re, enc_im, rand_factor,
                                 present=present, with_health=True,
                                 rel_tol=rel_tol, lam=lam, wire=wire)
    layers = (cfg.decode_granularity == "layer"
              and int(cfg.wire_segments) == 1)
    decoded, honest_l, health = cyclic_mod.decode_segments(
        code, enc_re, enc_im, rand_factor, bounds, present=present,
        with_health=True, rel_tol=rel_tol, lam=lam,
        wire=None if layers else wire)
    return decoded, honest_l.all(dim=0), health


def approx_aggregate(code, grads: torch.Tensor, vn_pres: torch.Tensor,
                     masked: bool = False, cfg=None, step=None,
                     present: Optional[torch.Tensor] = None,
                     adv_mask: Optional[torch.Tensor] = None):
    """The approx code's aggregation on the device: the ingest check of the
    (n, d) batch gradients, their encode into partial sums, the absent
    rows zero-filled by where-select (``masked``: the step has
    stragglers), the wire (``cfg.wire_dtype``), the decode — whole, or a
    segment at a time on the segmented wire (``cfg.wire_segments > 1``).
    ``vn_pres``: (2, n) [v/n, presence] on the device, from the host solve
    (``coding.approx.host_solve``); ``step``: the step's device tensor
    (stochastic rounding's draws); ``present``, ``adv_mask``: the step's
    masks on the device, for the forensics columns and the shadow.
    Returns ``(decoded mean (d,), health)``: ``residual`` (0-d),
    ``bad_rows`` (n,) and, with the observatory on, ``watch``. No
    adversary injection: the code carries no Byzantine certificate."""
    bad_rows = forensics.nonfinite_rows(grads)
    with phase("draco_encode"):
        rows = (topology.encode_tree(code, grads) if topology.is_tree(code)
                else approx_mod.encode_shared(code, grads))
        if masked:
            rows = torch.where(vn_pres[1][:, None] > 0, rows,
                               torch.zeros_like(rows))
        wire = (None if cfg is None
                else numerics.narrow_wire_single(cfg, rows, step))
        if wire is not None:
            rows = None  # the decode reads the narrow buffers
    with phase("draco_decode"):
        if cfg is not None and int(cfg.wire_segments) > 1:
            agg, residual = approx_mod.decode_segments_device(
                code, rows, grads, vn_pres,
                numerics.cfg_segment_bounds(cfg, grads.shape[1]), wire)
        else:
            agg, residual = approx_mod.decode_device(code, rows, grads,
                                                     vn_pres, wire)
    health = {"residual": residual, "bad_rows": bad_rows}
    if cfg is not None and numerics.watch_enabled(cfg):
        watch = {}
        if cfg.numerics_watch == "on":
            on_wire = (rows if wire is None
                       else numerics.widen_wire_rows(wire[1], wire[0],
                                                     wire[2]))
            watch.update(numerics.numerics_columns(cfg, [grads], [on_wire],
                                                   agg))
        if cfg.shadow_wire != "off":
            watch.update(numerics.approx_shadow(
                cfg, code, rows, grads, agg, vn_pres, present, adv_mask,
                step))
        health["watch"] = watch
    return agg, health


def aggregate_flat_grads(grads: torch.Tensor, adv_mask: torch.Tensor, cfg,
                         code, rand_factor, noise=None, step=None,
                         present: Optional[torch.Tensor] = None,
                         leaf_offsets=None, plan=None,
                         vn_pres: Optional[torch.Tensor] = None):
    """Per-worker flat gradients -> ``(aggregated (d,), health)``, the LM
    route's tail (the reference's ``aggregate_flat_grads``).

    cyclic: ``grads`` (n, hat_s, d) are the true redundant lanes
    (``simulate``: each worker encodes its own rows), (n, d) one copy per
    batch (``shared``: rows formed algebraically); the adversary injects on
    the encoded rows, the absent rows (``present`` False) are zero-filled,
    erasures at known positions, the pair crosses the wire
    (``cfg.wire_dtype``: f32, or the narrow bf16 / int8 buffers with their
    flag threshold and locator λ) and the decode recovers the exact mean —
    globally, or over the cuts of :func:`decode_bounds` (``leaf_offsets``:
    the leaf boundaries, which layer granularity needs). ``health``:
    ``residual``, ``flagged``, ``loud`` and ``honest``, folded across
    segments. approx: :func:`approx_aggregate` with the host solve's
    ``vn_pres`` (2, n) on the device; ``health``: ``residual`` and
    ``bad_rows``. Otherwise the adversary injects on the raw rows and the
    configured robust rule aggregates them over the ``present`` rows;
    ``health`` is None. ``noise``: the ``random`` attack's explicit draws,
    else they are drawn on the device from ``step`` (the step's int32
    tensor; attacks.py). ``plan``: the fault plan's in-step events on the
    device (``resilience/faults.plan_tensors``), applied to ``grads``
    first; None adds nothing."""
    grads = faults.corrupt_grads(grads, plan, step)
    if cfg.approach == "approx":
        return approx_aggregate(code, grads, vn_pres, present is not None,
                                cfg, step, present, adv_mask)
    if cfg.approach == "cyclic":
        # the ingest check before the encode, which smears a NaN over
        # every codeword: row k is still worker k here
        bad_rows = forensics.nonfinite_rows(grads)
        with phase("draco_encode"):
            if grads.dim() == 3:
                enc_re, enc_im = cyclic_mod.encode(code, grads)
            else:
                enc_re, enc_im = encode_shared(code, grads)
            enc_re, enc_im = attacks.inject_cyclic(
                enc_re, enc_im, adv_mask, cfg.err_mode, cfg.adversarial,
                noise, step, cfg.seed, cfg.num_adversaries)
            if present is not None:
                pw = present[:, None].to(enc_re.dtype)
                enc_re, enc_im = enc_re * pw, enc_im * pw
            enc_re, enc_im, wire = numerics.narrow_wire_pair(cfg, enc_re,
                                                             enc_im, step)
        bounds = decode_bounds(cfg, enc_re.shape[1], leaf_offsets)
        rel_tol, lam = cyclic_wire_params(cfg, code)
        with phase("draco_decode"):
            agg, honest, health = cyclic_decode(cfg, code, enc_re, enc_im,
                                                rand_factor, bounds,
                                                present=present,
                                                rel_tol=rel_tol, lam=lam,
                                                wire=wire)
        health["honest"] = honest
        health["bad_rows"] = bad_rows
        if numerics.watch_enabled(cfg):
            # the f32 decode above alone feeds the update
            watch = {}
            if cfg.numerics_watch == "on":
                watch.update(numerics.numerics_columns(
                    cfg, [grads], [enc_re, enc_im], agg))
            if cfg.shadow_wire != "off":
                watch.update(numerics.cyclic_shadow(
                    cfg, code, enc_re, enc_im, agg, health["flagged"],
                    rand_factor, leaf_offsets, present, adv_mask, step))
            health["watch"] = watch
        return agg, health
    grads = attacks.inject_plain(grads, adv_mask, cfg.err_mode,
                                 cfg.adversarial, noise, step, cfg.seed,
                                 n_mal=cfg.num_adversaries)
    with phase("draco_decode"):
        return (aggregation.aggregate(grads, cfg.mode, cfg.worker_fail,
                                      cfg.geomedian_iters, present), None)


def present_mean(values: torch.Tensor,
                 present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of per-worker (n,) values over the present workers: a
    straggler's loss was never observed."""
    if present is None:
        return values.mean()
    w = present.to(values.dtype)
    return (values * w).sum() / torch.clamp_min(w.sum(), 1.0)


def finish_flat_step(cfg, state, agg: torch.Tensor, health, layout,
                     present: Optional[torch.Tensor] = None) -> dict:
    """The step guard's verdict on the aggregate and the health
    (``resilience/guards.py``; the reference's guarded tail), then the
    optimizer update on the aggregated flat gradient, in place and gated
    by it. Returns the guard's columns ({} with the guard off, and the
    update is then the unguarded one). The step counter is the caller's:
    a captured step runs this once at capture."""
    ok, cols = guards.guard_update(cfg, agg, health, present)
    with phase("draco_update"):
        state.opt.step_flat(state.params, agg, layout, ok)
    return cols


def metric_family_names(cfg) -> tuple:
    """The optional column families a route appends after its base
    columns, for the CNN step and the LM alike: the code's health columns
    and the packed forensics masks, then the observatory's columns, then
    the step guard's. The baseline contributes only the guard's."""
    names = ()
    if cfg.approach == "cyclic":
        names += DECODE_HEALTH_NAMES
    elif cfg.approach == "approx":
        names += APPROX_HEALTH_NAMES
    elif cfg.approach == "maj_vote":
        names += VOTE_NAMES
    if cfg.approach != "baseline":
        names += forensics.mask_metric_names(cfg.num_workers)
    names += numerics.watch_metric_names(cfg)
    if cfg.step_guard == "on":
        names += guards.GUARD_METRIC_NAMES
    return names


def token_metric_names(cfg) -> tuple:
    """Column order of the LM metric record at ``cfg``."""
    return TOKEN_METRIC_NAMES + metric_family_names(cfg)


def accusation_mask(health: dict,
                    present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step's accusation set: the code's flags ∪ its loud rows ∪ the
    non-finite ingest rows, those of them the health carries (the approx
    code has no flags: its only signal is the ingest check), gated by
    ``present``."""
    accused = None
    for key in ("flagged", "loud", "bad_rows"):
        if key in health:
            m = health[key].to(torch.bool)
            accused = m if accused is None else accused | m
    if accused is None:
        raise ValueError("health dict carries no per-worker accusation "
                         "signal (flagged/loud/bad_rows)")
    if present is not None:
        accused = accused & present
    return accused


def decode_health_metrics(health, adv_mask: torch.Tensor,
                          present: Optional[torch.Tensor] = None) -> dict:
    """The health columns of a coded decode ({} for the baseline, whose
    health is None), the packed forensics masks and the observatory's
    columns (``health["watch"]``). The cyclic code's flag and adversary
    counts are gated by ``present`` — a straggling adversary's row never
    arrives, so it is neither detectable nor ground truth; the approx
    code's health (no ``flagged``) gives its residual (its bound and
    recovered fraction come from the host solve)."""
    if health is None:
        return {}
    watch = health.pop("watch", {})
    if "flagged" in health:
        flagged, adv = health["flagged"], adv_mask
        if present is not None:
            flagged, adv = flagged & present, adv & present
        out = {
            "decode_residual": health["residual"],
            "located_errors": flagged.sum(),
            "det_tp": (flagged & adv).sum(),
            "det_adv": adv.sum(),
        }
    else:
        out = {"decode_residual": health["residual"]}
    out.update(forensics.pack_mask_columns(
        accusation_mask(health, present), present, adv_mask))
    out.update(watch)
    return out
