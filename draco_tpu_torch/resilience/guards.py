"""The step guard (draco_tpu/resilience/guards.py): skip the update of an
untrusted step, branch-free, and keep training.

The decode is exact only inside the code's contract (≤ s Byzantine rows,
erasures within the budget, finite arithmetic). Outside it — an honest
worker's NaN or Inf gradient, corruption past the locator's budget, a vote
with no honest majority — the aggregate is poisoned without a sound. The
guard folds the step's health into one verdict:

  signal         trips when
  nonfinite      the aggregated / decoded flat gradient holds a NaN or an
                 Inf (every approach): one read of the aggregate by the
                 ``nonfinite_rows`` kernel, viewed as one row
  residual       cyclic: decode_residual > tol (a NaN residual trips);
                 approx: residual > bound + tol, the step's measured error
                 past its own analytic bound
  over_budget    the flagged rows that are present > s (the locator's
                 roots; the vote's out-voted rows)

where tol is ``cfg.guard_residual_tol`` plus the wire's residual slack
(``obs/numerics.wire_residual_slack``: 0 on the f32 wire, the rounding
noise a clean bf16 / int8 step sits at). Every comparison is written so
that a NaN lands on the untrusted side.

The verdict is a 0-d device bool, computed inside the step: a chunk is a
CUDA graph, so it cannot pass through the host. The update takes it as a
gate (``optim.Optimizer.step_flat(ok=)``): each in-place write — the
parameters, the rule's buffers, the update count, and on the CNN the BN
statistics — becomes ``torch.where(ok, new, old)``, which is exact both
ways: a trusted step's state is the unguarded step's bit for bit, a
skipped step's the previous step's bit for bit, update count included (the
reference's ``select_state`` keeps the whole optimizer state). Only the
step counter advances. The verdict ships as two metric columns
(``GUARD_METRIC_NAMES``, appended last by
``parallel/common.metric_family_names``), in the step's metric row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# the guard's columns, appended after every other family when
# cfg.step_guard == "on"
GUARD_METRIC_NAMES = ("guard_trips", "skipped_steps")


class GuardVerdict(NamedTuple):
    ok: torch.Tensor  # 0-d bool: the step's update is trusted
    trips: torch.Tensor  # 0-d int32: how many signals fired


def assess(cfg, agg: torch.Tensor, health: Optional[dict] = None,
           present: Optional[torch.Tensor] = None) -> GuardVerdict:
    """The step's verdict (module docstring). ``health``: the decode's
    health dict (``residual``, with ``bound`` under approx, and the
    ``flagged`` rows), None where no certificate exists (the baseline's
    robust rules: the finite check alone)."""
    from draco_tpu_torch.obs.numerics import wire_residual_slack
    from draco_tpu_torch.ops import numerics as numerics_ops

    tol = cfg.guard_residual_tol + wire_residual_slack(
        getattr(cfg, "wire_dtype", "f32"))
    flat = agg.reshape(1, -1)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    trips = [numerics_ops.nonfinite_rows(flat)[0]]
    if health is not None:
        # `not <=`: a NaN on either side is untrusted
        if "bound" in health:
            trips.append(~(health["residual"] <= health["bound"] + tol))
        elif "residual" in health:
            trips.append(~(health["residual"] <= tol))
        if "flagged" in health:
            flagged = health["flagged"].to(torch.bool)
            if present is not None:
                flagged = flagged & present
            trips.append(flagged.sum() > cfg.worker_fail)
    trip_vec = torch.stack([t.reshape(()).to(torch.bool) for t in trips])
    return GuardVerdict(ok=~trip_vec.any(),
                        trips=trip_vec.sum(dtype=torch.int32))


def metric_columns(verdict: GuardVerdict) -> dict:
    """The GUARD_METRIC_NAMES columns of the step's metrics."""
    return {"guard_trips": verdict.trips,
            "skipped_steps": (~verdict.ok).to(torch.int32)}


def guard_update(cfg, agg: torch.Tensor, health: Optional[dict] = None,
                 present: Optional[torch.Tensor] = None) -> tuple:
    """``(ok, columns)``: the gate the update takes and the guard's
    columns; ``(None, {})`` when cfg.step_guard is off, and the update is
    then the unguarded one."""
    if cfg.step_guard != "on":
        return None, {}
    verdict = assess(cfg, agg, health, present)
    return verdict.ok, metric_columns(verdict)
