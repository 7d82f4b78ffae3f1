"""Coded data parallelism × pipeline parallelism: the TransformerLM's
GPipe step (draco_tpu/parallel/pp_step.py), the stage axis a tensor axis.

The reference keeps the blocks as one scanned stack (:class:`StageBlocks`,
leaves ``blocks.loop.b.*`` with a leading layer axis L), shards that axis
over its ``pp`` mesh axis (S stages of L/S blocks) and runs the GPipe
schedule inside ``shard_map``: M + S − 1 ticks, each stage running its
blocks on the microbatch in flight and handing the result to its
successor with one ``ppermute`` hop. On one card the port keeps that
schedule with the stage axis as a tensor axis (:class:`PipelineLM`):

  * the stacked (L, …) block leaves are viewed as (S, L/S, …);
  * each tick runs all S stages at once, one stage body
    ``torch.func.vmap``-ed over the stage axis (nested in the lanes'
    vmap), each stage running its L/S layers on its microbatch;
  * the hop is a shift by one along the stage axis: stage 0 takes the
    tick's embedded microbatch (zeros in the bubble), stage s > 0 what
    stage s − 1 gave the tick before;
  * the last stage's outputs are collected from tick S − 1 on;
  * the embedding and the head run once (the reference's SPMD copies on
    the other stages contribute exact zeros).

Autograd differentiates the schedule as ``jax.grad`` transposes the
reference's. The loss is the reference's: all T positions are carried,
the last logit row is dropped, and the mean is over every microbatch's
B/M · (T − 1) positions. ``pp_microbatches`` M (0: S) keeps its meaning:
M + S − 1 ticks, each call on a microbatch of B/M rows.

One card gains no memory from the pipeline (every stage's parameters and
activations live on it) and pays (M + S − 1)/M of the blocks' compute for
the schedule: the bubble's ticks run on zeros. The route exists so that a
reference configuration with ``pipeline_shards > 1`` runs on the port and
gives the reference's results.

The tree is not the LM's: ``embed``, ``blocks.loop.b.*`` and ``final_ln``
are initialised from ``split(key(seed), 3)`` (the reference's three
``init`` calls), the blocks through the scan named ``loop`` and the block
named ``b`` (``models.layers.init_params`` with ``roots``). A pipeline
checkpoint and an LM one are not interchangeable. ``redundancy="simulate"``
warns and runs ``shared``, as the reference does; the route takes
``baseline|cyclic|approx`` and the autopilot cannot swap a regime on it.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call, vmap

from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.models.transformer import BlockStack, LayerNorm
from draco_tpu_torch.parallel.sp_step import (
    COMPUTE_DTYPES,
    SPTrainSetup,
    attn_fn_from_cfg,
    build_lm_setup,
    check_lm,
)
from draco_tpu_torch.runtime import resolve_device

SIMULATE_WARNING = ("pp path: redundancy='simulate' is not implemented; "
                    "using the algebraically-identical 'shared' encode")


class _Loop(nn.Module):
    """The reference's scan named ``loop`` over its block named ``b``."""

    def __init__(self, b: BlockStack):
        super().__init__()
        self.b = b


class StageBlocks(nn.Module):
    """``layers`` transformer blocks as one scanned stack (the reference's
    ``StageBlocks``): leaves ``loop.b.*`` with a leading layer axis, so a
    contiguous slice of the stack is a stage's tree."""

    def __init__(self, dim: int, heads: int, layers: int,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 attn_fn=None):
        super().__init__()
        self.loop = _Loop(BlockStack(layers, dim, heads, attn_fn=attn_fn,
                                     dtype=dtype, remat=remat))

    def forward(self, x, positions, params: Optional[dict] = None):
        """The stack (or, with ``params``, a stage's slice of it, names
        relative to ``loop.b``) on ``x``."""
        return self.loop.b(x, positions, 0, params)


class PipelineLM(nn.Module):
    """tokens (B, T) -> next-token logits (M, B/M, T, vocab) float32 of the
    M microbatches, through the GPipe schedule of S stages (module
    docstring)."""

    def __init__(self, vocab: int, dim: int, heads: int, layers: int,
                 stages: int, microbatches: int,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 attn_fn=None):
        super().__init__()
        if layers % stages:
            raise ValueError(f"model_layers {layers} not divisible by "
                             f"pp={stages}")
        self.S, self.M, self.dtype = stages, microbatches, dtype
        self.embed = nn.Embedding(vocab, dim)
        self.blocks = StageBlocks(dim, heads, layers, dtype, remat, attn_fn)
        self.final_ln = LayerNorm(dim)

    def stage_params(self) -> dict:
        """The stack's leaves (L, …) viewed as (S, L/S, …)."""
        S = self.S
        return {k: v.reshape(S, v.shape[0] // S, *v.shape[1:])
                for k, v in self.blocks.loop.b.named_parameters()}

    def forward(self, tokens):
        M = self.M
        b, t = tokens.shape
        if b % M:
            raise ValueError(f"microbatches {M} must divide batch_size {b}")
        x = self.embed(tokens).to(self.dtype)
        outs = self.schedule(x.reshape(M, b // M, t, x.shape[-1]),
                             torch.arange(t, device=tokens.device))
        h = self.final_ln(outs.to(torch.float32))
        return h @ self.embed.weight.t()

    def schedule(self, x_mb, positions):
        """The GPipe ticks on the embedded microbatches (M, mb, T, dim) ->
        the last stage's outputs (M, mb, T, dim)."""
        S, M = self.S, self.M
        stages = vmap(lambda ps, xs: self.blocks(xs, positions, ps))
        params = self.stage_params()
        bubble = torch.zeros_like(x_mb[0])
        out = torch.zeros((S,) + tuple(x_mb.shape[1:]), dtype=x_mb.dtype,
                          device=x_mb.device)
        outs = []
        for tick in range(M + S - 1):
            feed = x_mb[tick] if tick < M else bubble
            # the hop: stage s takes what stage s − 1 gave the tick before
            out = stages(params, torch.cat([feed[None], out[:-1]]))
            if tick >= S - 1:
                outs.append(out[S - 1])
        return torch.stack(outs)


def pipeline_objective(model: PipelineLM, cfg: TrainConfig, dev):
    """``(params, toks (B, T)) ->`` the reference's pipeline loss: the mean
    next-token cross-entropy over the M microbatches, the last logit row
    dropped."""
    def objective(p, toks):
        logits = functional_call(model, (p,), (toks,))
        logp = torch.log_softmax(logits, dim=-1)[:, :, :-1]
        tgt = toks[:, 1:].reshape(logits.shape[0], logits.shape[1], -1)
        return -logp.gather(-1, tgt[..., None])[..., 0].mean()
    return objective


class PPTrainSetup(SPTrainSetup):
    """The LM's shared setup under the reference's pipeline names."""

    __slots__ = ()

    @property
    def per_worker_loss(self):
        """(params, tokens (n, B, T) on the device) -> (n,) losses."""
        return self.lane_losses

    @property
    def per_worker_grads(self):
        """(params, tokens (n, B, T) on the device) -> ((n, d) flat
        gradients, (n,) losses)."""
        return self.lane_grads


def build_pp_train_setup(cfg: TrainConfig, device=None,
                         init: Optional[dict] = None) -> PPTrainSetup:
    """The pipeline step for ``cfg`` on ``device`` (default cuda):
    ``pipeline_shards`` stages, ``pp_microbatches`` (0: the stage count)
    microbatches. ``init``: optional parameters keyed by torch name
    (``params.from_jax`` of the reference's
    ``build_pp_train_setup(...).state.params``); otherwise the reference's
    draw of its three parts."""
    check_lm(cfg, "pp")
    if cfg.approach == "cyclic" and cfg.redundancy == "simulate":
        warnings.warn(SIMULATE_WARNING, stacklevel=2)
    S = cfg.pipeline_shards
    M = cfg.pp_microbatches or S

    def make_model():
        return PipelineLM(cfg.vocab, cfg.model_dim, cfg.model_heads,
                          cfg.model_layers, S, M,
                          dtype=COMPUTE_DTYPES[cfg.compute_dtype],
                          remat=cfg.remat, attn_fn=attn_fn_from_cfg(cfg))

    roots = dict(zip(("embed", "blocks", "final_ln"),
                     ((int(k[0]), int(k[1]))
                      for k in rng.split(rng.key(cfg.seed), 3))))
    setup = build_lm_setup(cfg, resolve_device(device), make_model,
                           pipeline_objective, init=init, roots=roots,
                           simulate=False)
    return PPTrainSetup(*setup)


def train_pp(cfg: TrainConfig, device=None, steps: Optional[int] = None,
             quiet: bool = False, profile_dir: Optional[str] = None,
             profile_steps: tuple = (3, 8)):
    """The pipeline training loop; returns (state, the last step's
    record)."""
    from draco_tpu_torch.parallel.token_loop import run_token_loop

    return run_token_loop(build_pp_train_setup(cfg, device), cfg, steps,
                          quiet, tag="pp", profile_dir=profile_dir,
                          profile_steps=profile_steps)
