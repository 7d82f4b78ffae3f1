"""Shared tail of the flat-gradient LM step (draco_tpu/parallel/common.py):
attack injection -> coded decode or robust aggregation -> optimizer update,
and the LM metric schema.

The port's slice: the cyclic code (``simulate`` and ``shared``) with the
global decode and the f32 wire, and the baseline ``mean`` /
``geometric_median``, with every row present. The reference's packed
forensics columns, numerics observatory and step guard are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from draco_tpu_torch import aggregation, attacks
from draco_tpu_torch.coding import cyclic as cyclic_mod

# column order of the LM metric block; cyclic appends DECODE_HEALTH_NAMES
TOKEN_METRIC_NAMES = ("loss",)

# per-step decode-health columns of the cyclic code:
#   decode_residual  self-consistency residual, ≈ 0 iff the decode is exact
#   located_errors   rows the decode flagged as corrupt
#   det_tp           flagged ∧ adversarial (true positives)
#   det_adv          adversarial (the detectable ground truth)
DECODE_HEALTH_NAMES = ("decode_residual", "located_errors", "det_tp",
                       "det_adv")


def build_code_from_cfg(cfg) -> Optional[cyclic_mod.CyclicCode]:
    """The CyclicCode for approach="cyclic", None for the baseline."""
    if cfg.approach == "cyclic":
        return cyclic_mod.build_cyclic_code(cfg.num_workers, cfg.worker_fail)
    return None


def aggregate_flat_grads(grads: torch.Tensor, adv_mask: torch.Tensor, cfg,
                         code, rand_factor, noise=None, generator=None):
    """Per-worker flat gradients -> ``(aggregated (d,), health)``.

    cyclic: ``grads`` (n, hat_s, d) are the true redundant lanes
    (``simulate``: each worker encodes its own rows), (n, d) one copy per
    batch (``shared``: rows formed algebraically); the adversary injects on
    the encoded rows and the decode recovers the exact mean. ``health``:
    ``residual``, ``flagged``, ``loud`` and ``honest``. Otherwise the
    adversary injects on the raw rows and the configured robust rule
    aggregates them; ``health`` is None. ``noise`` / ``generator``: the
    ``random`` attack's draws (attacks.py)."""
    if cfg.approach == "cyclic":
        if grads.dim() == 3:
            enc_re, enc_im = cyclic_mod.encode(code, grads)
        else:
            enc_re, enc_im = cyclic_mod.encode_shared(code, grads)
        enc_re, enc_im = attacks.inject_cyclic(
            enc_re, enc_im, adv_mask, cfg.err_mode, cfg.adversarial, noise,
            generator)
        agg, honest, health = cyclic_mod.decode(code, enc_re, enc_im,
                                                rand_factor, with_health=True)
        health["honest"] = honest
        return agg, health
    grads = attacks.inject_plain(grads, adv_mask, cfg.err_mode,
                                 cfg.adversarial, noise, generator)
    return aggregation.aggregate(grads, cfg.mode, cfg.geomedian_iters), None


def masked_loss_metric(losses: torch.Tensor) -> torch.Tensor:
    """Mean loss over the workers (every row is present in this slice)."""
    return losses.mean()


def finish_flat_step(state, agg: torch.Tensor, layout) -> None:
    """The optimizer update on the aggregated flat gradient, in place, and
    the step counter (the reference's guard is not ported yet)."""
    from draco_tpu_torch import params as params_mod

    state.opt.step(state.params, params_mod.unflatten(agg, layout))
    state.step += 1


def token_metric_names(cfg) -> tuple:
    """Column order of the LM metric record at ``cfg``."""
    names = TOKEN_METRIC_NAMES
    if cfg.approach == "cyclic":
        names += DECODE_HEALTH_NAMES
    return names


def decode_health_metrics(health, adv_mask: torch.Tensor) -> dict:
    """The DECODE_HEALTH_NAMES columns from a decode-health dict and the
    step's adversary mask ({} for the baseline, whose health is None)."""
    if health is None:
        return {}
    flagged = health["flagged"]
    return {
        "decode_residual": health["residual"],
        "located_errors": flagged.sum(),
        "det_tp": (flagged & adv_mask).sum(),
        "det_adv": adv_mask.sum(),
    }
