"""Coded data parallelism × expert parallelism: the Switch-MoE
TransformerLM's ep step (draco_tpu/parallel/ep_step.py) on one card.

The reference shards the expert stacks' leading E axis over its ``ep``
mesh axis (:func:`ep_partition_spec`) and keeps the router and every other
parameter replicated; GSPMD localises each expert's FFN. The expert FFN
einsums are batched over E and change nothing; only the combine
``ecd,nec->nd`` and the dispatch's backward contract over E. Routing is
top-1 and one-hot, so each token's (e, c) row has one nonzero entry: split
into one partial a group of E / ``expert_shards`` experts, every other
group's partial is an exact zero and the sum is the one einsum's, bit for
bit. So on one card the ep step runs the MoE LM of the default route
(``models/moe.MoeMlp``) as it is, and ``expert_shards`` changes nothing
but the route. No process group is used. :data:`EXPERT_PARAMS` and
:func:`ep_partition_spec` state the reference's partition for parity with
it; the program reads neither.

The rest is the tp route's (``tp_step.py``; the reference's tp and ep
share one builder): the LM's shared step, ``baseline|cyclic|approx``, no
autopilot rebuild.
"""

from __future__ import annotations

from typing import Optional

from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.parallel.sp_step import (
    SPTrainSetup,
    build_lm_setup,
    check_lm,
    lm_model,
    next_token_objective,
)
from draco_tpu_torch.runtime import resolve_device

EXPERT_PARAMS = ("w1", "w2", "b1", "b2")
EP_AXIS = "ep"


def ep_partition_spec(path) -> tuple:
    """The reference's partition of the leaf at Flax ``path``: an expert
    stack's leading E axis over ``ep`` (``("ep",)``, or ``(None, "ep")``
    under ``scan_layers``), everything else replicated (``()``)."""
    names = list(path)
    if len(names) >= 2 and names[-2] == "moe" and names[-1] in EXPERT_PARAMS:
        return (None, EP_AXIS) if "blocks" in names else (EP_AXIS,)
    return ()


def build_ep_train_setup(cfg: TrainConfig, device=None,
                         init: Optional[dict] = None) -> SPTrainSetup:
    """The ep step for ``cfg`` on ``device`` (default cuda): the MoE LM
    (module docstring). ``init`` as ``build_sp_train_setup`` takes it."""
    check_lm(cfg, "ep")
    return build_lm_setup(cfg, resolve_device(device), lambda: lm_model(cfg),
                          next_token_objective, init=init)


def train_ep(cfg: TrainConfig, device=None, steps: Optional[int] = None,
             quiet: bool = False):
    """The ep training loop; returns (state, the last step's record)."""
    from draco_tpu_torch.parallel.token_loop import run_token_loop

    return run_token_loop(build_ep_train_setup(cfg, device), cfg, steps,
                          quiet, tag="ep")
