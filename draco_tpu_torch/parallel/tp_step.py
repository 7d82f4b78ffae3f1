"""Coded data parallelism × tensor parallelism: the TransformerLM's tp
step (draco_tpu/parallel/tp_step.py), the shard axis a tensor axis.

The reference partitions the parameters by name over its ``tp`` mesh axis
(:func:`param_partition_spec`: Megatron's column-parallel ``qkv`` and
``mlp_in``, row-parallel ``proj`` and ``mlp_out``) and lets GSPMD insert
the all-reduces. The sharding changes only where sums split into
per-shard partial sums, so on one card the port writes those partial sums
out (``models/transformer.Dense``): a column-parallel layer computes one
product a contiguous block of ``tensor_shards`` output blocks and
concatenates them, a row-parallel one one product a block of its
contraction, each in the compute dtype, summed over the shards in
ascending order, its replicated bias added once after the sum. Autograd
builds the backward's reductions from them: the input gradient of a
column-parallel layer is the sum of the blocks' partials, as the
reference's all-reduce gives it. No process group is used.

Everything else is the LM's shared step (``sp_step.build_lm_setup``): the
lanes, the coded tail, the chunk and the loop. The tree is the unrolled
(or ``scan_layers``) LM's, so the initial draws are ``model.init``'s, and
with ``moe_experts`` at one shard the route runs the Switch MoE, as the
reference's does. The route takes ``baseline|cyclic|approx``; the
autopilot cannot swap a regime on it (the reference passes no rebuild).
"""

from __future__ import annotations

from typing import Optional

from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.models.transformer import TP_FORMS
from draco_tpu_torch.parallel.sp_step import (
    SPTrainSetup,
    build_lm_setup,
    check_lm,
    lm_model,
    next_token_objective,
)
from draco_tpu_torch.runtime import resolve_device

TP_AXIS = "tp"


def param_partition_spec(path) -> tuple:
    """The reference's Megatron partition of the leaf at Flax ``path``
    (a sequence of names), as a spec tuple, from the forms the Block's
    Dense layers take (``models/transformer.TP_FORMS``): ``(None, "tp")``
    column-parallel kernels (``qkv``, ``mlp_in``), ``("tp", None)``
    row-parallel ones (``proj``, ``mlp_out``), ``("tp",)`` a
    column-parallel bias (``mlp_in``'s), ``()`` replicated; under
    ``scan_layers`` the dims shift right by one. For parity with the
    reference: the port's form reads ``TP_FORMS`` itself."""
    names = list(path)
    leaf = names[-1]
    form = TP_FORMS.get(names[-2]) if len(names) >= 2 else None
    if leaf == "kernel" and form == "column":
        spec = (None, TP_AXIS)
    elif leaf == "kernel" and form == "row":
        spec = (TP_AXIS, None)
    elif leaf == "bias" and form == "column":
        spec = (TP_AXIS,)
    else:
        return ()
    if "blocks" in names:
        spec = (None,) + spec
    return spec


def build_tp_train_setup(cfg: TrainConfig, device=None,
                         init: Optional[dict] = None) -> SPTrainSetup:
    """The tp step for ``cfg`` on ``device`` (default cuda): the LM in its
    ``tensor_shards``-way Megatron form (experts honoured at one shard).
    ``init`` as ``build_sp_train_setup`` takes it."""
    check_lm(cfg, "tp")
    return build_lm_setup(
        cfg, resolve_device(device),
        lambda: lm_model(cfg, tensor_shards=max(cfg.tensor_shards, 1)),
        next_token_objective, init=init)


def train_tp(cfg: TrainConfig, device=None, steps: Optional[int] = None,
             quiet: bool = False):
    """The tp training loop; returns (state, the last step's record)."""
    from draco_tpu_torch.parallel.token_loop import run_token_loop

    return run_token_loop(build_tp_train_setup(cfg, device), cfg, steps,
                          quiet, tag="tp")
