"""Optimizers with the "aggregated gradient as argument" semantics
(draco_tpu/optim.py).

The update takes the decoded or aggregated gradient as an argument. The
rules are torch's formulations, as the reference pins them:

  SGD     buf ← μ·buf + (1−dampening)·g (first step: buf = g), d = buf
          (nesterov: d = g + μ·buf)
  Adam    m ← β1·m + (1−β1)·g;  v ← β2·v + (1−β2)·g²
          d = √(1−β2ᵗ)/(1−β1ᵗ) · m/(√v + ε)   (ε outside the root)
  AdamW   Adam's d on the raw gradient, plus λ·p (decay decoupled)

and every rule runs at lr = 1: the schedule then scales its step, p ← p −
lr(t)·d, which is the reference's ``chain(rule(1.0),
scale_by_schedule(lr))``. So AdamW's decay is scaled by the schedule, and
under a constant schedule (−1·d)·lr equals −(d·lr): SGD gives the bits of
``p − lr·buf``. ``clip_norm`` > 0 scales the incoming gradient by
min(1, c/‖g‖) over its global norm before the rule, with no state.

The optimizer's state lives on the gradient's device and is updated in
place: the rule's buffers and one int32 update count ``t`` (Adam's t − 1
and the schedule's t, one tensor). The schedule and Adam's bias
corrections are computed from that tensor on the device, never from a host
number, so one captured step replays them (``training/chunk_graph.py``).
:meth:`Optimizer.init` makes the state before the first step (zero
buffers: μ·0 + g = g, so the first step is the reference's, a −0
gradient entry aside, which it turns into +0); a step that finds none
makes it then. With ``dampening`` ≠ 0 the first step's buffer is g by a
select on the count, as in the reference.

:meth:`Optimizer.jax_leaves` lists the state as the leaves of the
reference's ``chain(rule, scale_by_schedule)`` state: the rule's (SGD's
momentum buffers, zeros at momentum 0, and its ``initialized`` flag, the
count > 0 with momentum and False without; Adam's count, ``exp_avg`` and
``exp_avg_sq``), then the schedule's int32 count. Both of the reference's
counts are the port's one count.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from draco_tpu_torch import params as params_mod

SCHEDULES = ("constant", "cosine")
OPTIMIZERS = ("sgd", "adam", "adamw")


def gated(dst: torch.Tensor, new: torch.Tensor, ok) -> None:
    """``dst`` ← ``new`` where the 0-d bool ``ok`` holds, else ``dst`` as
    it was: a select, exact both ways (a multiplicative gate is not: NaN·0
    is NaN). ``ok`` None: a plain copy."""
    if ok is None:
        dst.copy_(new)
    else:
        torch.where(ok, new, dst, out=dst)


class Rule:
    """An update rule at lr = 1: its buffers (name -> one zero tensor a
    parameter) and :meth:`direction`, the d of p ← p − lr·d, which
    updates the buffers in place."""

    buffers: tuple = ()

    def direction(self, grads: dict, bufs: dict, params: dict,
                  count: torch.Tensor, ok=None) -> dict:
        """``ok``: the step guard's 0-d bool gate, or None; with a gate
        each buffer write keeps the old value where ``ok`` is False."""
        raise NotImplementedError

    def jax_leaves(self, bufs: dict, count: torch.Tensor, lay) -> list:
        """The leaves of the reference's state of this rule."""
        raise NotImplementedError


class SGDRule(Rule):
    """torch.optim.SGD (the reference's ``sgd_modified``)."""

    def __init__(self, momentum: float = 0.0, dampening: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False):
        self.momentum, self.dampening = momentum, dampening
        self.weight_decay, self.nesterov = weight_decay, nesterov
        self.buffers = ("momentum",) if momentum != 0.0 else ()

    def direction(self, grads, bufs, params, count, ok=None):
        out = {}
        for k, g in grads.items():
            if self.weight_decay != 0.0:
                g = g + self.weight_decay * params[k]
            if self.momentum == 0.0:
                out[k] = g
                continue
            buf = bufs["momentum"][k]
            if self.dampening == 0.0:
                if ok is None:
                    buf.mul_(self.momentum).add_(g)
                else:
                    gated(buf, buf * self.momentum + g, ok)
            else:
                later = self.momentum * buf + (1.0 - self.dampening) * g
                gated(buf, torch.where(count > 0, later, g), ok)
            out[k] = g + self.momentum * buf if self.nesterov else buf
        return out

    def jax_leaves(self, bufs, count, lay):
        # SGDState(momentum_buf, initialized): the reference keeps (zero)
        # buffers at momentum 0 too, and its flag stays False there
        momentum = self.momentum != 0.0
        flag = params_mod.StateLeaf(
            (), np.dtype(bool),
            lambda: np.asarray(momentum and count.item() > 0),
            lambda a: None)
        return ((params_mod.tensor_leaves(bufs["momentum"], lay) if momentum
                 else params_mod.zero_leaves(lay)) + [flag])


class AdamRule(Rule):
    """torch.optim.Adam (the reference's ``adam_modified``); with
    ``decoupled`` > 0, AdamW's decay λ·p added to the direction
    (``adamw_modified``)."""

    buffers = ("exp_avg", "exp_avg_sq")

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: float = 0.0):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.decoupled = weight_decay, decoupled

    def direction(self, grads, bufs, params, count, ok=None):
        t = (count + 1).to(torch.float32)
        step_size = (torch.sqrt(1.0 - torch.pow(self.b2, t))
                     / (1.0 - torch.pow(self.b1, t)))
        out = {}
        for k, g in grads.items():
            if self.weight_decay != 0.0:
                g = g + self.weight_decay * params[k]
            m, v = bufs["exp_avg"][k], bufs["exp_avg_sq"][k]
            if ok is None:
                m.mul_(self.b1).add_((1.0 - self.b1) * g)
                v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            else:
                gated(m, m * self.b1 + (1.0 - self.b1) * g, ok)
                gated(v, v * self.b2 + (1.0 - self.b2) * g * g, ok)
            d = step_size * m / (torch.sqrt(v) + self.eps)
            if self.decoupled != 0.0:
                d = d + self.decoupled * params[k]
            out[k] = d
        return out

    def jax_leaves(self, bufs, count, lay):
        # AdamState(count, exp_avg, exp_avg_sq)
        return ([params_mod.scalar_leaf(count)]
                + params_mod.tensor_leaves(bufs["exp_avg"], lay)
                + params_mod.tensor_leaves(bufs["exp_avg_sq"], lay))


def sgd_modified(momentum: float = 0.0, dampening: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False) -> Rule:
    return SGDRule(momentum, dampening, weight_decay, nesterov)


def adam_modified(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  weight_decay: float = 0.0) -> Rule:
    return AdamRule(b1, b2, eps, weight_decay)


def adamw_modified(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.01) -> Rule:
    return AdamRule(b1, b2, eps, decoupled=weight_decay)


def lr_schedule(name: str, lr: float, warmup_steps: int = 0,
                total_steps: int = 0) -> Callable:
    """t (the 0-based update count, an int tensor) -> the learning rate.

    "constant": lr, a host number. "cosine": a float32 tensor on t's
    device, (t+1)/warmup · lr during the warmup (step 0 already moves,
    step warmup−1 is at the peak), then a cosine decay to 10% of lr at
    ``total_steps``."""
    if name == "constant":
        return lambda t: lr
    if name == "cosine":
        floor = 0.1 * lr
        span = max(total_steps - warmup_steps, 1)

        def sched(t):
            t = torch.as_tensor(t).to(torch.float32)
            warm = lr * (t + 1.0) / max(warmup_steps, 1)
            frac = torch.clamp((t - warmup_steps) / span, 0.0, 1.0)
            cos = floor + (lr - floor) * 0.5 * (1.0 + torch.cos(math.pi
                                                                * frac))
            return torch.where(t < warmup_steps, warm, cos)

        return sched
    raise ValueError(f"unknown lr schedule: {name}")


class Optimizer:
    """A rule, a schedule and the global-norm clip (module docstring)."""

    def __init__(self, rule: Rule, schedule: Callable, clip_norm: float = 0.0):
        self.rule, self.schedule, self.clip_norm = rule, schedule, clip_norm
        self.count: Optional[torch.Tensor] = None
        self.state: dict = {}  # buffer name -> {param name: tensor}

    @torch.no_grad()
    def init(self, params: dict) -> None:
        """Zero buffers and the count on the parameters' device, unless
        they exist."""
        if self.count is not None:
            return
        dev = next(iter(params.values())).device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        for name in self.rule.buffers:
            self.state.setdefault(
                name, {k: torch.zeros_like(p) for k, p in params.items()})

    zero_bufs = init

    @property
    def bufs(self) -> Optional[dict]:
        """SGD's momentum buffers (None without momentum)."""
        return self.state.get("momentum")

    @bufs.setter
    def bufs(self, value: dict) -> None:
        self.state["momentum"] = value

    def tensors(self) -> dict:
        """The state's tensors: every buffer and the count."""
        out = {f"{name}/{k}": v for name, bufs in self.state.items()
               for k, v in bufs.items()}
        if self.count is not None:
            out["opt/count"] = self.count
        return out

    def jax_leaves(self, lay) -> list:
        """The state as the leaves of the reference's optimizer state
        (module docstring), read and written in place."""
        return (self.rule.jax_leaves(self.state, self.count, lay)
                + [params_mod.scalar_leaf(self.count)])

    def clip_scale(self, norm: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.clip_norm / torch.clamp_min(norm, 1e-16),
                           max=1.0)

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        """One update of ``params`` in place from ``grads`` (same keys)."""
        self.init(params)
        if self.clip_norm > 0.0:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            scale = self.clip_scale(norm)
            grads = {k: g * scale for k, g in grads.items()}
        self._apply(params, grads)

    @torch.no_grad()
    def step_flat(self, params: dict, flat: torch.Tensor, layout,
                  ok: Optional[torch.Tensor] = None) -> None:
        """:meth:`step` on a flat (d,) gradient in the reference's layout;
        the clip takes one norm of the flat vector. ``ok``: the step
        guard's 0-d bool gate (``resilience/guards.py``): where it is
        False the parameters, the rule's buffers and the update count stay
        bit for bit as they were; where True the update is the ungated one
        bit for bit. None: the ungated update."""
        self.init(params)
        if self.clip_norm > 0.0:
            flat = flat * self.clip_scale(torch.linalg.vector_norm(flat))
        self._apply(params, params_mod.unflatten(flat, layout), ok)

    def _apply(self, params: dict, grads: dict, ok=None) -> None:
        if ok is None:
            d = self.rule.direction(grads, self.state, params, self.count)
            lr = self.schedule(self.count)
            for k, p in params.items():
                p.sub_(d[k] * lr)
            self.count.add_(1)
            return
        d = self.rule.direction(grads, self.state, params, self.count, ok)
        lr = self.schedule(self.count)
        for k, p in params.items():
            gated(p, p - d[k] * lr, ok)
        self.count.add_(ok.to(torch.int32))


def build_optimizer(name: str, lr: float, momentum: float = 0.0,
                    weight_decay: float = 0.01, schedule: str = "constant",
                    warmup_steps: int = 0, total_steps: int = 0,
                    clip_norm: float = 0.0) -> Optimizer:
    """The reference's ``build_optimizer``: the rule at lr = 1, scaled by
    the schedule, behind the clip. ``weight_decay`` is AdamW's decoupled
    decay (sgd and adam take none here)."""
    if schedule != "constant" and total_steps <= 0:
        raise ValueError(
            f"schedule={schedule!r} needs total_steps > 0 (got "
            f"{total_steps}); without it the decay span collapses and the "
            f"whole run trains at the floor rate")
    if name == "sgd":
        rule = sgd_modified(momentum=momentum)
    elif name == "adam":
        rule = adam_modified()
    elif name == "adamw":
        rule = adamw_modified(weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    return Optimizer(rule, lr_schedule(schedule, lr, warmup_steps,
                                       total_steps), clip_norm)


def build_optimizer_from_cfg(cfg) -> Optimizer:
    """One mapping from TrainConfig to the optimizer, shared by the CNN
    step and the LM step."""
    return build_optimizer(
        cfg.optimizer, cfg.lr, cfg.momentum,
        weight_decay=cfg.weight_decay, schedule=cfg.lr_schedule,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.max_steps,
        clip_norm=cfg.clip_norm)


def SGD(lr: float, momentum: float = 0.0) -> Optimizer:
    """SGD with momentum at a constant rate."""
    return build_optimizer("sgd", lr, momentum)
