"""One coded data-parallel training step (draco_tpu/training/step.py).

The reference runs the whole parameter-server protocol as one jitted SPMD
program; the port runs it eagerly on one device, with the worker axis a
real tensor axis:

  per-lane value-and-grad   ``torch.func.vmap`` of ``grad_and_value`` over
                            n lanes (baseline, shared) or n·(2s+1) lanes
                            (simulate), each with its worker's BN stats
  attack                    masked injection (``attacks``)
  encode                    ``coding.cyclic.encode`` / ``encode_shared``
  decode                    project → locator → recombine (the kernels)
  update                    SGD with momentum on the decoded gradient

Gradients are flattened in the reference's leaf order and layout
(``params.flatten``), so the (n, d) codeword matrix, the random projection
and the decode agree with the reference coordinate for coordinate.

Randomness: augmentation draws come from a ``torch.Generator`` per global
batch row k (per worker on the baseline), folded from (seed + 2, step, k),
drawn on the host so every device sees the same draws; the random
projection from (seed, 7919). ``train_step`` takes explicit ``aug_draws``,
``rand_factor`` and ``noise`` overrides so the tests can hand it the
reference's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch.func import functional_call, grad_and_value, vmap

from draco_tpu_torch import aggregation, attacks, optim
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng as drng
from draco_tpu_torch.coding import cyclic as cyclic_mod
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import augment as augment_mod
from draco_tpu_torch.models import build_model
from draco_tpu_torch.models.resnet import init_params, init_stats
from draco_tpu_torch.ops.decode_kernels import resolve_decode_impl
from draco_tpu_torch.runtime import resolve_device

AUG_SALT = 2  # the reference's augmentation seed salt (seed + 2)

DECODE_HEALTH_NAMES = ("decode_residual", "located_errors", "det_tp",
                       "det_adv")


@dataclasses.dataclass
class TrainState:
    params: dict  # torch name -> tensor (torch layout); updated in place
    stats: dict  # "<path>/mean" | "<path>/var" -> (n, features) per worker
    opt: optim.SGD
    step: int = 1  # the reference's STEP_START = 1


class TrainSetup(NamedTuple):
    model: Any
    state: TrainState
    # (state, x, y, adv_mask, aug_draws=None, rand_factor=None, noise=None)
    #   -> (state, metrics dict of 0-d tensors)
    train_step: Any
    code: Optional[cyclic_mod.CyclicCode]
    layout: params_mod.Layout
    dim: int
    metric_names: tuple
    device: torch.device
    decode_impl: str  # which locator runs: "cuda" (the kernel) | "plain"


def _cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def metric_names(cfg: TrainConfig) -> tuple:
    names = ("loss", "prec1")
    if cfg.approach == "cyclic":
        names += ("honest_located",) + DECODE_HEALTH_NAMES
    return names


def aug_draws(cfg: TrainConfig, step: int, rows: int):
    """Per-row augmentation draws (top, left, flip), each (rows, B) int64,
    from the host generator of (seed + 2, step, row)."""
    draws = [augment_mod.draw((cfg.batch_size,),
                              drng.generator(cfg.seed + AUG_SALT, step, k))
             for k in range(rows)]
    return tuple(torch.stack(d) for d in zip(*draws))


def build_train_setup(cfg: TrainConfig, device=None,
                      dataset_name: Optional[str] = None,
                      init: Optional[tuple] = None) -> TrainSetup:
    """Model, state and the step for ``cfg`` on ``device`` (default cuda).

    ``init``: optional ``(params, stats)`` as ``params.from_jax`` returns
    them (stats with or without the leading worker axis); otherwise the
    parameters are drawn from ``cfg.seed``."""
    cfg.validate()
    dev = resolve_device(device)
    n = cfg.num_workers
    dataset_name = dataset_name or cfg.dataset
    use_aug = "cifar" in dataset_name.lower()

    model = build_model(cfg.network, dataset_name)
    if init is None:
        init_params(model, drng.generator(cfg.seed))
        stats0 = init_stats(model)
    else:
        p0, stats0 = init
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(p0[name])
    model.to(dev)
    params = {k: p.detach() for k, p in model.named_parameters()}
    stats = {k: (v if v.dim() == 2 else v.expand(n, -1)).to(dev).clone()
             for k, v in stats0.items()}
    layout = params_mod.layout(model)
    dim = layout.dim
    state = TrainState(params=params, stats=stats,
                       opt=optim.SGD(cfg.lr, cfg.momentum))

    def loss_fn(p, st, x, y):
        logits, new_st = functional_call(model, (p,), (x, st))
        loss = _cross_entropy(logits, y)
        prec1 = (logits.argmax(-1) == y).float().mean()
        return loss, (new_st, prec1)

    lanes_fn = vmap(grad_and_value(loss_fn, has_aux=True),
                    in_dims=(None, 0, 0, 0))

    def lanes(p, st, x, y):
        """(lanes, B, ...) -> flat grads (lanes, d), new stats, losses,
        precs."""
        g, (loss, (new_st, prec1)) = lanes_fn(p, st, x, y)
        return params_mod.flatten(g, layout, lead=1), new_st, loss, prec1

    def prep(state, x, y, rows, draws):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev).long()
        if use_aug:
            if draws is None:
                draws = aug_draws(cfg, state.step, rows)
            x = augment_mod.augment(x, *draws)
        return x, y

    def attack_generator(state, noise):
        """The random attack's per-step generator, unless noise was given."""
        if cfg.err_mode == "random" and noise is None:
            return attacks.random_generator(cfg.seed, state.step, device=dev)
        return None

    def update(state, flat_grad, new_stats):
        state.opt.step(state.params, params_mod.unflatten(flat_grad, layout))
        state.stats = {k: v.detach() for k, v in new_stats.items()}
        state.step += 1

    code = None
    decode_impl = resolve_decode_impl(cfg.decode_impl, dev)
    if cfg.approach == "baseline":

        def train_step(state, x, y, adv_mask, aug_draws=None,
                       rand_factor=None, noise=None):
            del rand_factor
            x, y = prep(state, x, y, n, aug_draws)
            grads, new_stats, losses, precs = lanes(state.params, state.stats,
                                                    x, y)
            gen = attack_generator(state, noise)
            mask = torch.as_tensor(adv_mask, device=dev)
            grads = attacks.inject_plain(grads, mask, cfg.err_mode,
                                         cfg.adversarial, noise, gen)
            agg = aggregation.aggregate(grads, cfg.mode, cfg.geomedian_iters)
            update(state, agg, new_stats)
            return state, {"loss": losses.mean(), "prec1": precs.mean()}

    else:  # cyclic
        code = cyclic_mod.build_cyclic_code(n, cfg.worker_fail)
        hat_s = code.hat_s
        batch_ids = torch.as_tensor(code.batch_ids, device=dev).long()
        # every participant derives the same projection; drawn once on the
        # host, like the augmentation draws
        projection = drng.random_projection_factors(cfg.seed, dim).to(dev)

        def compute_encoded(state, x, y):
            if cfg.redundancy == "shared":
                # each batch row computed once, combined with the masked W
                grads, new_stats, losses, precs = lanes(
                    state.params, state.stats, x, y)
                enc_re, enc_im = cyclic_mod.encode_shared(code, grads)
                return enc_re, enc_im, new_stats, losses, precs
            # simulate: worker i computes its hat_s batch rows, with its
            # own BN stats on each of them
            xw = x[batch_ids].flatten(0, 1)
            yw = y[batch_ids].flatten(0, 1)
            st = {k: v[:, None].expand(n, hat_s, v.shape[-1]).flatten(0, 1)
                  for k, v in state.stats.items()}
            grads, new_stats, losses, precs = lanes(state.params, st, xw, yw)
            enc_re, enc_im = cyclic_mod.encode(code,
                                               grads.view(n, hat_s, dim))
            # fold the per-lane stats back to one set per worker
            new_stats = {k: v.view(n, hat_s, -1).mean(1)
                         for k, v in new_stats.items()}
            return (enc_re, enc_im, new_stats, losses.view(n, hat_s).mean(1),
                    precs.view(n, hat_s).mean(1))

        def train_step(state, x, y, adv_mask, aug_draws=None,
                       rand_factor=None, noise=None):
            x, y = prep(state, x, y, n, aug_draws)
            enc_re, enc_im, new_stats, losses, precs = compute_encoded(
                state, x, y)
            gen = attack_generator(state, noise)
            mask = torch.as_tensor(adv_mask, device=dev)
            enc_re, enc_im = attacks.inject_cyclic(
                enc_re, enc_im, mask, cfg.err_mode, cfg.adversarial, noise,
                gen)
            f = projection if rand_factor is None else torch.as_tensor(
                rand_factor, device=dev)
            decoded, honest, health = cyclic_mod.decode(
                code, enc_re, enc_im, f, with_health=True)
            update(state, decoded, new_stats)
            flagged = health["flagged"]
            return state, {
                "loss": losses.mean(),
                "prec1": precs.mean(),
                "honest_located": honest.sum(),
                "decode_residual": health["residual"],
                "located_errors": flagged.sum(),
                "det_tp": (flagged & mask).sum(),
                "det_adv": mask.sum(),
            }

    return TrainSetup(model=model, state=state, train_step=train_step,
                      code=code, layout=layout, dim=dim,
                      metric_names=metric_names(cfg), device=dev,
                      decode_impl=decode_impl)
