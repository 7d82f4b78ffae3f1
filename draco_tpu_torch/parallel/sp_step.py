"""The coded TransformerLM training step (draco_tpu/parallel/sp_step.py).

Each logical worker's gradient of the masked next-token cross-entropy is a
lane of ``torch.func.vmap(grad_and_value(...))`` on one device: n lanes
(the baseline and ``shared``) or n·(2s+1) lanes (``simulate``: worker i
computes its 2s+1 batch rows ``tokens[batch_ids[i]]``). The flat gradients
(``params.flatten``, the reference's leaf order and layout) go through the
shared tail of ``parallel/common.py``: inject, encode, zero-fill the
absent rows, cross the wire (f32, or the narrow bf16 / int8 buffers) and
decode — the cyclic code, the approx code (its weights solved on the host
for the step's arrival set), each flat or as a tree — or aggregate by a
robust rule over the present rows, then the configuration's optimizer
(``optim.build_optimizer_from_cfg``). The loss is the mean over the
present workers: a straggler's loss was never observed.

The loss: position t predicts token t+1; the last position has no target
and is masked, and the sum is divided by B·(T−1). (The reference's shard
also predicts its successor shard's first token through one ppermute hop,
the global last position masked, and its per-shard sums add up over sp to
this loss; at sp=1 that hop brings back the shard's own first token,
masked.)

Sequence parallelism (``seq_shards`` = sp > 1) on one card: the shard
axis is a tensor axis of the attention, so the model runs on the full (B,
T) with global positions, the objective is the single-shard one, and the
reference's psum over sp of the shards' gradients is what autograd
computes over the whole sequence. Only the attention changes
(:func:`attn_fn_from_cfg`, as the reference picks it): the ring
(``parallel/ring_attention.py``), dense or with the flash kernels at every
hop, or the a2a head scatter (``parallel/a2a_attention.py``) around dense
attention or the flash kernels. ``remat`` and ``scan_layers`` build the
model with the recompute and the stacked layers
(``models/transformer.py``); the initial parameters are the reference's
``model.init`` of that tree, which differs between the two layouts.

:func:`build_lm_setup` is what every LM route shares: the state, the
lanes, the coded tail, the eager step, the chunk and the eval. The
default route gives it the TransformerLM (with ``moe_experts`` Switch
experts a block, ``models/moe.py``) and this objective; the tp and ep
routes (``tp_step.py``, ``ep_step.py``) the same objective on the model
in its tensor- or expert-parallel form, the pipeline (``pp_step.py``) its
own model and loss.

The decode runs globally or, at ``decode_granularity="layer"`` and on the
segmented wire (``wire_segments > 1``), over the leaf boundaries and the
segment cuts (``parallel/common.decode_bounds``).

The initial parameters are the reference's ``model.init`` under
``key(seed)`` (``models.layers.init_params``, drawn on the device leaf by
leaf), and the decode's random projection its in-graph vector
(``rng.projection_factors``), drawn once at setup on the device.

As in ``training/step.py``, ``step_body`` runs the step on its host inputs
(the tokens and ``training/step.coded_inputs``: the adversary mask — none
on the approx code — the presence mask when a row is absent, the int32
step number, and on the approx code the host solve's v/n and presence and,
under the step guard, its bound) once they are on the device; the approx
decode's ``decode_residual_bound`` and ``recovered_fraction`` are host
columns (a chunk's ``Chunk.host``). The eager ``train_step`` uploads the
inputs, ``train_token_many`` (the counterpart of the reference's
``train_token_many`` at sp=1) runs a chunk of k ≤ K steps from the
chunk's staging buffers (``training/chunk_graph.py``). The fault plan's in-step events
(``resilience/faults.py``) corrupt the lanes' gradients on the device from
the staged step, and the step guard gates the update
(``parallel/common.finish_flat_step``). With ``cfg.token_gen="device"`` the host
sends no tokens: the step makes its batch on the device from the staged
step (``synthetic_text_in_graph``, the reference's stream, by the
``synthetic_text`` kernel of ``ops/draws.py``), so a chunk stages K step
numbers and the masks. The random attack draws on the device from the same
staged step.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from draco_tpu_torch import optim
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng as rng_mod
from draco_tpu_torch.config import LM_NETWORK, TrainConfig
from draco_tpu_torch.models.layers import init_params
from draco_tpu_torch.models.transformer import TransformerLM
from draco_tpu_torch.ops.coded import segment_plan
from draco_tpu_torch.ops.decode_kernels import resolve_decode_impl
from draco_tpu_torch.ops.flash_attention import attn_impl_fn
from draco_tpu_torch.parallel.a2a_attention import a2a_attention
from draco_tpu_torch.parallel.common import (
    aggregate_flat_grads,
    build_code_from_cfg,
    decode_bounds,
    decode_health_metrics,
    finish_flat_step,
    present_mean,
    token_metric_names,
)
from draco_tpu_torch.parallel.ring_attention import (ring_attention,
                                                     ring_flash_attention)
from draco_tpu_torch.obs.tracer import phase
from draco_tpu_torch.ops import draws
from draco_tpu_torch.resilience import faults
from draco_tpu_torch.runtime import resolve_device, upload
from draco_tpu_torch.training.step import (
    APPROX_HOST_NAMES,
    TrainState,
    chunk_runner,
    coded_inputs,
    stack_chunk,
)

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SPTrainSetup(NamedTuple):
    model: TransformerLM
    state: TrainState
    # (state, tokens (n, B, T) or None (token_gen="device"), adv_mask (n,),
    #  present=None, noise=None) -> (state, metrics dict of 0-d tensors)
    train_step: Any
    eval_step: Any  # (params, tokens (n, B, T)) -> mean loss (0-d tensor)
    # CyclicCode | ApproxCode | TreeCode (topology="tree") | None
    code: Any
    layout: params_mod.Layout
    dim: int
    metric_names: tuple
    device: torch.device
    decode_impl: str  # which locator runs: "cuda" (the kernel) | "plain"
    # (state, inputs on the device, noise=None) -> the
    # metrics of block_names (0-d device tensors)
    step_body: Any
    # metric_names but the approx code's host columns, and honest_located
    # on the cyclic code
    block_names: tuple
    # (start, tokens (k, n, B, T) or None (token_gen="device"), masks
    #  (k, n), presents (k, n) or None) -> Chunk
    make_chunk: Any
    # (state, chunk) -> (state, (k, len(block_names)) metrics on the device)
    train_token_many: Any
    # (params, tokens (lanes, B, T) on the device) -> flat gradients
    # (lanes, d), losses (lanes,): the step's gradient phase alone
    lane_grads: Any = None
    # (params, tokens (lanes, B, T) on the device) -> losses (lanes,), no
    # gradient (the eval's)
    lane_losses: Any = None
    # cfg -> a regime's setup around this one's live model and state (the
    # autopilot's swaps); None on the routes the reference swaps on none
    # of (tp, pp, ep)
    rebuild: Any = None


def synthetic_text(seed: int, step: int, n: int, batch: int,
                   seq_len: int, vocab: int):
    """Deterministic learnable token stream: ramps t_{i+1} = t_i + stride
    with
    per-sequence stride ∈ {1, 2}. Same (seed, step) ⇒ same batch everywhere."""
    r = np.random.RandomState((seed * 1_000_003 + step) % (2**31 - 1))
    start = r.randint(0, vocab, size=(n, batch, 1))
    stride = r.randint(1, 3, size=(n, batch, 1))
    idx = np.arange(seq_len)[None, None, :]
    return ((start + stride * idx) % vocab).astype(np.int32)


def synthetic_text_in_graph(seed: int, step, n: int, batch: int,
                            seq_len: int, vocab: int) -> torch.Tensor:
    """The reference's device counterpart of :func:`synthetic_text`
    (cfg.token_gen == "device"): the same ramps from its threefry stream,
    ``fold_in(key(seed), step)`` split into the starts' and the strides'
    keys, made on ``step``'s device (the ``synthetic_text`` kernel on the
    card). ``step``: the step's int32 tensor of one element."""
    return draws.synthetic_text(step, seed, n, batch, seq_len, vocab)


def token_fn_from_cfg(cfg: TrainConfig):
    """``step -> (n, B, T)`` int32 tokens for cfg.token_gen == "device",
    None for the host stream."""
    if cfg.token_gen != "device":
        return None
    return lambda step: synthetic_text_in_graph(
        cfg.seed, step, cfg.num_workers, cfg.batch_size, cfg.seq_len,
        cfg.vocab)


def attn_fn_from_cfg(cfg: TrainConfig):
    """The LM's attention as the reference picks it
    (``build_sp_train_setup``): at one shard the flash kernels or (None)
    the Block's dense default; at sp > 1 the ring with the flash kernels
    at every hop, the a2a head scatter around them, or the dense ring or
    a2a."""
    flash = attn_impl_fn(cfg)
    sp = cfg.seq_shards
    if sp == 1:
        return flash
    if flash is not None and cfg.sp_attn == "ring":
        return functools.partial(ring_flash_attention, shards=sp)
    if flash is not None:
        return functools.partial(a2a_attention, shards=sp, inner=flash)
    route = ring_attention if cfg.sp_attn == "ring" else a2a_attention
    return functools.partial(route, shards=sp)


def model_key(cfg: TrainConfig) -> tuple:
    """What the built model depends on: a setup that shares a live
    setup's model (``live=``) must agree on it."""
    return (cfg.vocab, cfg.model_dim, cfg.model_heads, cfg.model_layers,
            cfg.compute_dtype, cfg.attn_impl, cfg.tensor_shards,
            cfg.moe_experts, cfg.expert_shards, cfg.pipeline_shards,
            cfg.pp_microbatches, cfg.seq_shards, cfg.sp_attn, cfg.remat,
            cfg.scan_layers)


def lm_model(cfg: TrainConfig, tensor_shards: int = 1) -> TransformerLM:
    """The TransformerLM of ``cfg`` (its experts, remat and layer stack,
    the attention :func:`attn_fn_from_cfg` picks), in the tensor-parallel
    form of ``tensor_shards``."""
    return TransformerLM(vocab=cfg.vocab, dim=cfg.model_dim,
                         heads=cfg.model_heads, layers=cfg.model_layers,
                         attn_fn=attn_fn_from_cfg(cfg),
                         dtype=COMPUTE_DTYPES[cfg.compute_dtype],
                         remat=cfg.remat, scan_layers=cfg.scan_layers,
                         experts=cfg.moe_experts,
                         tensor_shards=tensor_shards)


def next_token_objective(model, cfg: TrainConfig, dev):
    """``(params, toks (B, T)) -> `` the masked mean next-token
    cross-entropy of ``model`` (module docstring)."""
    T = cfg.seq_len
    # position t predicts t+1; the last position has no target
    pos_valid = (torch.arange(T, device=dev) < T - 1).to(torch.float32)
    denom = cfg.batch_size * (T - 1)

    def objective(p, toks):
        logits = functional_call(model, (p,), (toks,))
        targets = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return (nll * pos_valid).sum() / denom
    return objective


def check_lm(cfg: TrainConfig, route: str = "sp") -> None:
    """The checks every LM route's builder makes of ``cfg``: validated,
    the LM's network, and on the model-parallel routes (tp, pp, ep) only
    ``baseline|cyclic|approx``, as the reference's builders take."""
    cfg.validate()
    if cfg.network != LM_NETWORK:
        raise ValueError(f"the LM step runs network={LM_NETWORK}, got "
                         f"{cfg.network!r}")
    if route != "sp" and cfg.approach not in ("baseline", "cyclic",
                                              "approx"):
        raise ValueError(f"{'PP' if route == 'pp' else 'MP'} path supports "
                         f"baseline|cyclic|approx, got {cfg.approach}")


def build_sp_train_setup(cfg: TrainConfig, device=None,
                         init: Optional[dict] = None,
                         live: Optional[SPTrainSetup] = None
                         ) -> SPTrainSetup:
    """Model, state and the step for ``cfg`` on ``device`` (default cuda):
    the LM (with ``cfg.moe_experts`` Switch experts a block) on the
    sequence-parallel route, one shard or ``seq_shards``.

    ``init``: optional parameters keyed by torch name (``params.from_jax``
    of the reference's); otherwise the reference's ``model.init`` at
    ``cfg.seed``, drawn on the device.

    ``live``: a running setup whose model and ``TrainState`` this one takes
    as they are (an autopilot regime, ``control/autopilot.py``, as
    ``training/step.build_train_setup(live=)``): its step and its chunk's
    graph read and update the same parameter, optimizer and count tensors,
    so switching between the two copies no weights. ``cfg`` must keep the
    live setup's model (``model_key``) and worker count."""
    check_lm(cfg)
    dev = resolve_device(device)
    setup = build_lm_setup(cfg, dev, lambda: lm_model(cfg),
                           next_token_objective, init=init, live=live)
    return setup._replace(rebuild=lambda c: build_sp_train_setup(
        c, dev, live=setup))


def build_lm_setup(cfg: TrainConfig, dev, make_model, make_objective,
                   init: Optional[dict] = None,
                   live: Optional[SPTrainSetup] = None,
                   roots: Optional[dict] = None,
                   simulate: bool = True) -> SPTrainSetup:
    """What every LM route shares, around the route's model and objective:
    ``make_model()`` the route's module (made on ``dev``),
    ``make_objective(model, cfg, dev)`` its ``(params, toks (B, T)) ->``
    loss of one lane. The state is ``live``'s, or the model's with
    ``init`` or the reference's draw (``init_params``, ``roots`` as it
    takes them); the lanes are ``vmap(grad_and_value(objective))``, n or
    (``simulate`` and the cyclic code's ``redundancy="simulate"``)
    n·(2s+1) of them, and the tail the shared one (module docstring)."""
    n = cfg.num_workers
    if live is not None:
        if init is not None:
            raise ValueError("build_sp_train_setup: init and live exclude "
                             "each other (a live setup's state is the state)")
        if live.device != dev:
            raise ValueError(f"build_sp_train_setup: the live setup runs on "
                             f"{live.device}, not {dev}")
        if live.model.key != model_key(cfg):
            raise ValueError(f"build_sp_train_setup: the live setup's model "
                             f"is {live.model.key}, cfg's {model_key(cfg)}")
        model, state, layout = live.model, live.state, live.layout
    else:
        # made on the device: its initial values are all drawn again below
        with torch.device(dev):
            model = make_model()
        model.key = model_key(cfg)
        with torch.no_grad():
            if init is None:
                init_params(model, cfg.seed, roots=roots)
            else:
                for name, p in model.named_parameters():
                    p.copy_(init[name])
        params = {k: p.detach() for k, p in model.named_parameters()}
        layout = params_mod.layout(model)
        state = TrainState(params=params, stats={},
                           opt=optim.build_optimizer_from_cfg(cfg))
        state.opt.init(params)
    dim = layout.dim
    objective = make_objective(model, cfg, dev)
    lanes_fn = vmap(grad_and_value(objective), in_dims=(None, 0))

    def lane_grads(p, toks):
        """(lanes, B, T) -> flat grads (lanes, d), losses (lanes,)."""
        with phase("draco_comp"):
            g, loss = lanes_fn(p, toks)
            return params_mod.flatten(g, layout, lead=1), loss

    code = build_code_from_cfg(cfg)
    decode_impl = resolve_decode_impl(cfg.decode_impl, dev)
    cyclic = cfg.approach == "cyclic"
    approx = cfg.approach == "approx"
    simulate = simulate and cyclic and cfg.redundancy == "simulate"
    batch_ids = (torch.as_tensor(code.batch_ids, device=dev).long()
                 if simulate else None)
    # the reference's projection, the same vector every step: drawn once,
    # on the device (the approx decode is projection-free)
    projection = None
    if cyclic:
        projection = rng_mod.projection_factors(cfg.seed, dim, dev)
        # the segmented decode's plan goes to the card here, before any
        # capture
        bounds = decode_bounds(cfg, dim, layout.offsets)
        if bounds is not None:
            segment_plan(bounds, dev)
    # the fault plan's in-step events, on the card from setup (None: none)
    plan = faults.plan_tensors(faults.plan_from_cfg(cfg), dev)
    names = token_metric_names(cfg)
    # the approx decode's bound and recovered fraction come from the host
    # solve: they go into the records beside the block, not through it
    host_names = APPROX_HOST_NAMES if approx else ()
    # not a column of the reference's LM schema: for callers that check the
    # honest set (n − 2s rows on every clean decode)
    honest = ("honest_located",) if cyclic else ()
    block_names = tuple(k for k in names if k not in host_names) + honest
    # the guard's approx certificate reads the host solve's bound, staged
    # beside v/n (coded_inputs)
    stage_bound = approx and cfg.step_guard == "on"

    token_fn = token_fn_from_cfg(cfg)

    def host_tokens(tokens) -> dict:
        """The tokens among the host inputs, unless the device makes
        them."""
        return {} if token_fn is not None else {
            "tokens": torch.as_tensor(tokens)}

    def make_chunk(start, tokens, masks, presents=None):
        per = [coded_inputs(cfg, code, start + i, masks[i],
                            None if presents is None else presents[i])
               for i in range(len(masks))]
        return stack_chunk(start, per, host_tokens(tokens),
                           (start, tokens, masks, presents))

    def step_body(state, inputs, noise=None):
        step = inputs["step"]
        toks = (inputs["tokens"] if token_fn is None
                else token_fn(step)).long()
        pres = inputs.get("present")
        # no adversary on the approx code: the schedule's row is all False
        mask = (inputs["adv"] if not approx
                else torch.zeros((n,), dtype=torch.bool, device=dev))
        if simulate:
            hat_s = code.hat_s
            grads, losses = lane_grads(state.params,
                                       toks[batch_ids].flatten(0, 1))
            grads = grads.view(n, hat_s, dim)
            losses = losses.view(n, hat_s).mean(dim=1)
        else:
            grads, losses = lane_grads(state.params, toks)
        agg, health = aggregate_flat_grads(grads, mask, cfg, code, projection,
                                           noise, step, present=pres,
                                           leaf_offsets=layout.offsets,
                                           plan=plan,
                                           vn_pres=inputs.get("vn_pres"))
        del grads
        # the approx certificate: the residual within the host solve's bound
        guard_health = ({"residual": health["residual"],
                         "bound": inputs["bound"]} if stage_bound
                        else health)
        guard_cols = finish_flat_step(cfg, state, agg, guard_health, layout,
                                      pres)
        # a straggler's loss was never observed
        metrics = {"loss": present_mean(losses, pres)}
        metrics.update(decode_health_metrics(health, mask, pres))
        metrics.update(guard_cols)
        if cyclic:
            metrics["honest_located"] = health["honest"].sum()
        return metrics

    def train_step(state, tokens, adv_mask, present=None, noise=None):
        """One step; ``present``: the host's (n,) bool presence mask
        (False = the worker's rows never arrive), None when all arrive."""
        inputs, host = coded_inputs(cfg, code, state.step, adv_mask,
                                    present)
        inputs.update(host_tokens(tokens))
        # host inputs by pinned asynchronous copies: no synchronising call
        metrics = step_body(state, {k: upload(v, dev)
                                    for k, v in inputs.items()}, noise)
        state.step += 1
        metrics.update(host)
        # the host columns take their places in the schema's order
        return state, {k: metrics[k] for k in names + honest}

    lane_losses = torch.no_grad()(vmap(objective, in_dims=(None, 0)))

    def eval_step(p, tokens):
        return lane_losses(p, upload(torch.as_tensor(tokens), dev).long()
                           ).mean()

    train_token_many = chunk_runner(
        f"train_token_many[{cfg.approach}/{cfg.redundancy}]", cfg, dev,
        state, step_body, block_names)
    return SPTrainSetup(model=model, state=state, train_step=train_step,
                        eval_step=eval_step, code=code, layout=layout,
                        dim=dim, metric_names=names, device=dev,
                        decode_impl=decode_impl, step_body=step_body,
                        block_names=block_names, make_chunk=make_chunk,
                        train_token_many=train_token_many,
                        lane_grads=lane_grads, lane_losses=lane_losses)


def train_sp(cfg: TrainConfig, device=None, steps: Optional[int] = None,
             quiet: bool = False):
    """The LM training loop on the synthetic token stream; returns the
    final state and the last step's record. The autopilot's regime swaps
    rebuild the step around the live model and state."""
    from draco_tpu_torch.parallel.token_loop import run_token_loop

    return run_token_loop(build_sp_train_setup(cfg, device), cfg, steps,
                          quiet, tag="sp")
