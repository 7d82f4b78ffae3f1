"""One coded data-parallel training step (draco_tpu/training/step.py).

The reference runs the whole parameter-server protocol as one jitted SPMD
program; the port runs it eagerly on one device, with the worker axis a
real tensor axis:

  per-lane value-and-grad   ``torch.func.vmap`` of ``grad_and_value`` over
                            n lanes (baseline, maj_vote, shared, approx) or
                            n·(2s+1) lanes (simulate), each with its
                            worker's BN stats
  faults                    the seeded fault plan's in-step events
                            (``resilience/faults.py``: NaN / Inf rows, the
                            drift) on the lanes' gradients, from the staged
                            step
  attack                    masked injection (``attacks``)
  encode                    ``coding.cyclic.encode`` / ``encode_shared``,
                            ``coding.approx.encode_shared``
  stragglers                absent rows zero-filled (``present``)
  wire                      f32, or bf16 / int8 buffers (``obs.numerics``)
  decode                    cyclic: project → locator → recombine, over
                            the whole d or column segments (the layer
                            decode, ``wire_segments > 1``); approx:
                            host weight solve → one-pass decode (kernels)
                            a segment at a time;
                            maj_vote: row fingerprints (kernel) → the vote
                            a group; baseline: the robust rule
                            (``aggregation``) over the present rows
  observe                   the ingest check of the raw gradients
                            (``nonfinite_rows``) and the packed forensics
                            masks on every coded step; under
                            ``numerics_watch`` / ``shadow_wire`` the
                            statistics of the gradients, the wire and the
                            aggregate and a shadow decode of the rounded
                            wire (``obs/numerics.py``) — before the
                            update, which the f32 decode alone feeds
  update                    the optimizer of the configuration
                            (``optim.build_optimizer_from_cfg``: SGD,
                            Adam or AdamW under a constant or cosine
                            schedule, behind the global-norm clip) on the
                            decoded flat gradient; with ``step_guard="on"``
                            gated by the step's verdict
                            (``resilience/guards.py``): an untrusted step
                            keeps the parameters, the optimizer's state and
                            the BN statistics bit for bit

The repetition code's lanes run under ``torch.backends.cudnn
.deterministic`` (``vote_lanes``): its vote needs the members of a group,
which compute the same batch, to give bit-identical gradients. At cuDNN's
default settings on an H100 they do not: every honest lane differed from
its group's others in about half of ResNet-18's coordinates, every step
(PERF.md §6).

The state carry is updated in place: parameters, the optimizer's buffers
and update count, and the BN statistics keep their storage across steps.
A setup built with ``live=`` (an autopilot regime, ``control/autopilot.py``)
takes a running setup's model and state as they are, so several setups'
steps and chunk graphs update one state.
The step is split in two: its host inputs (batch, labels, the adversary
and presence masks, the int32 step number; the approx decode's host
solve), and ``step_body``, which
runs the step on them once they are on the device. The eager
``train_step`` sends them by pinned asynchronous copies
(``runtime.upload``), so the step makes no synchronising call: the program
lint (``analysis/``) holds it to both. ``train_many`` runs a chunk of k ≤
K = ``steps_per_call`` steps from the chunk's device staging buffers
(``training/chunk_graph.py``): on the card as replays of the step
captured in a CUDA graph, on the CPU as k eager runs of the same body,
bit for bit the k eager steps. The phases run under
``obs.tracer.phase`` (``draco_comp``, ``draco_encode``, ``draco_decode``,
``draco_update``, the reference's ``jax.named_scope`` names), which mark
host spans and profiler ranges when a tracer or the profiler is on and
cost nothing otherwise.

``eval_step`` is the reference's: correct@1 and correct@5 counts over a
test batch's valid rows, with worker 0's running statistics and no
dropout (``training/evaluator.py`` pads and masks the ragged last batch).
``TrainState.leaves`` lists the state as the reference's ``TrainState``
leaves, which a checkpoint holds, and ``TrainState.load`` writes such
leaves back in place.

Gradients are flattened in the reference's leaf order and layout
(``params.flatten``), so the (n, d) codeword matrix, the random projection
and the decode agree with the reference coordinate for coordinate.

Randomness: every draw is the reference's, on its key chain
(``rng.py``, ``ops/draws.py``). The initial parameters are Flax's
``model.init`` under ``key(seed)`` (``models.layers.init_params``); the
decode's random projection is ``1 + normal(fold_in(key(seed), 7919))``,
drawn once at setup on the device (the reference redraws the same vector
in every step). In the step, on the device from the staged step: the
augmentation draws of global batch row k (worker k on the baseline, the
group of k on maj_vote) under fold(key(seed + 2), step, k); a model's
dropout keep-masks under fold(key(seed + 3), step, k), so every lane that
computes batch k (the 2s+1 copies under ``simulate``, a group's members on
maj_vote) drops the same units and the decode stays exact; the vote's two
fingerprint salts under fold(key(seed + 4), step); the random attack and
stochastic rounding. ``step_body`` reads the step from its inputs, never
from ``state.step``, so a captured step replays each step's own draws.
``train_step`` takes the random attack's explicit ``noise`` (tests) and
the step's ``present`` mask (the host's (n,) bool, False = the worker's
row never arrives; None = all arrive); ``make_chunk`` takes the chunk's
masks.

The compute dtype (``cfg.compute_dtype``) is the reference's: the
convolutions and Dense layers compute in it, parameters, BN statistics and
the logits stay float32 (``models/layers.py``), and the flat gradient is
float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from draco_tpu_torch import aggregation, attacks, optim
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng as rng_mod
from draco_tpu_torch.coding import cyclic as cyclic_mod
from draco_tpu_torch.coding import repetition as rep_mod
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import augment as augment_mod
from draco_tpu_torch.models import build_model
from draco_tpu_torch.models.layers import init_params, init_stats
from draco_tpu_torch.obs import forensics, numerics
from draco_tpu_torch.obs.tracer import phase
from draco_tpu_torch.ops import draws as draws_ops
from draco_tpu_torch.ops.coded import segment_plan
from draco_tpu_torch.ops.decode_kernels import resolve_decode_impl
from draco_tpu_torch.optim import gated
from draco_tpu_torch.parallel.common import (
    approx_aggregate,
    build_code_from_cfg,
    cyclic_decode,
    cyclic_wire_params,
    decode_bounds,
    decode_health_metrics,
    encode_shared,
    host_solve,
    metric_family_names,
    present_mean,
)
from draco_tpu_torch.resilience import faults, guards
from draco_tpu_torch.runtime import cudnn_deterministic, resolve_device, upload
from draco_tpu_torch.training.chunk_graph import Chunk, StepGraph

# the approx decode's columns that the host solve gives (coding/approx.py)
APPROX_HOST_NAMES = ("decode_residual_bound", "recovered_fraction")


@dataclasses.dataclass
class TrainState:
    params: dict  # torch name -> tensor (torch layout); updated in place
    stats: dict  # "<path>/mean" | "<path>/var" -> (n, features) per worker
    opt: optim.Optimizer
    step: int = 1  # the reference's STEP_START = 1: the next step to run

    def tensors(self) -> dict:
        """The state's tensors: parameters, the optimizer's buffers and
        update count, statistics."""
        out = {f"params/{k}": v for k, v in self.params.items()}
        out.update(self.opt.tensors())
        out.update({f"stats/{k}": v for k, v in self.stats.items()})
        return out

    # ---- the reference's leaves (checkpoints) ---------------------------
    def leaves(self, lay: params_mod.Layout) -> list:
        """The state as ``jax.tree.leaves`` of the reference's
        ``TrainState(params, opt_state, batch_stats, step)``: the
        parameters (sorted paths, JAX layouts), the optimizer's state
        (``Optimizer.jax_leaves``), the statistics with their leading
        worker axis, and the int32 step (the next step to run), each a
        ``params.StateLeaf``."""
        step = params_mod.StateLeaf(
            (), np.dtype(np.int32), lambda: np.asarray(self.step, np.int32),
            lambda a: setattr(self, "step", int(a.item())))
        return (params_mod.tensor_leaves(self.params, lay)
                + self.opt.jax_leaves(lay)
                + params_mod.stats_leaves(self.stats) + [step])

    def specs(self, lay: params_mod.Layout) -> list:
        """Each leaf's shape and dtype (what ``utils/checkpoint.load``
        checks), read off no tensor."""
        from draco_tpu_torch.utils.checkpoint import LeafSpec

        return [LeafSpec(x.shape, x.dtype) for x in self.leaves(lay)]

    def arrays(self, lay: params_mod.Layout) -> list:
        """The leaves as numpy arrays (copies off the device; the copies
        queue behind the work on the current stream)."""
        return [x.read() for x in self.leaves(lay)]

    @torch.no_grad()
    def load(self, arrays, lay: params_mod.Layout) -> None:
        """Write the reference-ordered ``arrays`` into the state in place:
        every tensor keeps its storage, so a captured graph
        (``training/chunk_graph.py``) goes on updating the restored
        state. Raises ValueError on a structural mismatch, before any
        write."""
        leaves = self.leaves(lay)
        if len(arrays) != len(leaves):
            raise ValueError(f"{len(arrays)} arrays for a state of "
                             f"{len(leaves)} leaves")
        for i, (x, a) in enumerate(zip(leaves, arrays)):
            if tuple(a.shape) != tuple(x.shape) or a.dtype != x.dtype:
                raise ValueError(f"leaf {i}: {a.shape}/{a.dtype}, the state "
                                 f"has {x.shape}/{x.dtype}")
        for x, a in zip(leaves, arrays):
            x.write(a)


class TrainSetup(NamedTuple):
    model: Any
    state: TrainState
    # (state, x, y, adv_mask, noise=None, present=None)
    #   -> (state, metrics dict of 0-d tensors)
    train_step: Any
    code: Any  # CyclicCode | ApproxCode | RepetitionCode | None
    layout: params_mod.Layout
    dim: int
    metric_names: tuple
    device: torch.device
    decode_impl: str  # which locator runs: "cuda" (the kernel) | "plain"
    # (state, inputs on the device, noise=None) -> the
    # metrics of block_names (0-d device tensors); no host work, no upload
    step_body: Any
    block_names: tuple  # the metric columns the device computes
    # (start, xs, ys, masks, presents=None) -> Chunk
    make_chunk: Any
    # (state, chunk) -> (state, (k, len(block_names)) metrics on the device)
    train_many: Any
    # (state, x (B, H, W, C), y (B,), valid (B,) bool) -> the correct@1 and
    # correct@5 counts over the valid rows (0-d tensors)
    eval_step: Any


def _cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def metric_names(cfg: TrainConfig) -> tuple:
    """The CNN step's columns: its base columns, then the optional
    families of ``parallel.common.metric_family_names``."""
    names = ("loss", "prec1")
    if cfg.approach == "cyclic":
        names += ("honest_located",)
    return names + metric_family_names(cfg)


def detection_metrics(flagged, adv_mask, present=None) -> dict:
    """Per-step detection counts against the seeded schedules: flagged,
    flagged ∧ adversarial (true positives) and adversarial, each among the
    present rows (a straggling adversary's row never arrives)."""
    adv, flagged = adv_mask.bool(), flagged.bool()
    if present is not None:
        adv, flagged = adv & present, flagged & present
    return {"det_flagged": flagged.sum(), "det_tp": (flagged & adv).sum(),
            "det_adv": adv.sum()}


def vote_lanes(device: torch.device):
    """The maj_vote lanes' setting: deterministic cuDNN on the card (no
    effect on the CPU), the vote's bitwise-equality contract."""
    return (cudnn_deterministic() if device.type == "cuda"
            else contextlib.nullcontext())


def coded_inputs(cfg: TrainConfig, code, step: int, adv_mask,
                 present=None) -> tuple:
    """One step's host inputs other than its batch, and its host columns,
    for the CNN step and the LM's alike: the step number (every device
    draw reads it), the adversary mask (none on the approx code, which
    injects none: stragglers are its whole fault model, config.validate),
    the presence mask when a row is absent; on the approx code the host
    solve's [v/n, presence] and, under the step guard, its bound (the
    certificate reads it), with ``decode_residual_bound`` and
    ``recovered_fraction`` as host columns."""
    out, host = {"step": torch.tensor(step, dtype=torch.int32)}, {}
    if cfg.approach == "approx":
        _, out["vn_pres"], solved = host_solve(code, present)
        host = {"decode_residual_bound": solved["bound"],
                "recovered_fraction": solved["recovered_fraction"]}
        if cfg.step_guard == "on":
            out["bound"] = solved["bound"].to(torch.float32).reshape(())
    else:
        out["adv"] = torch.as_tensor(adv_mask)
    if present is not None:
        out["present"] = torch.as_tensor(present).cpu().bool()
    return out, host


def stack_chunk(start: int, per: list, whole: dict, pieces: tuple) -> Chunk:
    """A ``Chunk`` of ``len(per)`` steps from each step's ``coded_inputs``
    ``per`` (stacked) and the inputs already stacked over the chunk
    (``whole``: the batch, the tokens); the host columns read off their
    host tensors without an op (no would-be sync in the lint)."""
    return Chunk(start, len(per),
                 {**whole, **{name: torch.stack([p[0][name] for p in per])
                              for name in per[0][0]}},
                 {name: [float(p[1][name].tolist()) for p in per]
                  for name in per[0][1]},
                 pieces)


def metrics_row(metrics: dict, names: tuple) -> torch.Tensor:
    """A step's metrics as one float32 row in ``names`` order."""
    return torch.stack([metrics[k].to(torch.float32) for k in names])


def chunk_runner(name: str, cfg: TrainConfig, dev, setup_state, body,
                 block_names: tuple):
    """``train_many`` of a setup: the first chunk makes the optimizer's
    state, if no step has, and the :class:`StepGraph` over ``body(state,
    inputs) -> metrics``, bound to ``setup_state``; each chunk then runs
    through it and advances the state's step counter."""
    box = {}

    def train_many(state, chunk: Chunk):
        if state is not setup_state:
            raise ValueError(f"{name}: the chunk runs on the setup's own "
                             f"state, which its graph updates in place")
        if "graph" not in box:
            # a no-op once the buffers exist: a regime's setup built
            # mid-run (``live=``) keeps the momentum and the count
            state.opt.init(state.params)
            box["graph"] = StepGraph(
                name, dev, cfg.steps_per_call, block_names,
                lambda inputs: metrics_row(body(state, inputs), block_names),
                state.tensors)
        block = box["graph"].run(chunk)
        state.step += chunk.k
        return state, block

    train_many.graph = lambda: box.get("graph")
    return train_many


def build_train_setup(cfg: TrainConfig, device=None,
                      dataset_name: Optional[str] = None,
                      init: Optional[tuple] = None,
                      live: Optional["TrainSetup"] = None) -> TrainSetup:
    """Model, state and the step for ``cfg`` on ``device`` (default cuda).

    ``init``: optional ``(params, stats)`` as ``params.from_jax`` returns
    them (stats with or without the leading worker axis); otherwise the
    parameters are the reference's ``model.init`` at ``cfg.seed``, drawn
    on the device.

    ``live``: a running setup whose model and ``TrainState`` this one
    takes as they are (an autopilot regime, ``control/autopilot.py``): its
    step, and its chunk's graph, read and update the same parameter,
    momentum, statistics and count tensors, so switching between the two
    copies no weights. ``cfg`` must keep the live setup's network and
    worker count."""
    cfg.validate()
    dev = resolve_device(device)
    n = cfg.num_workers
    dataset_name = dataset_name or cfg.dataset
    use_aug = "cifar" in dataset_name.lower()

    if live is not None:
        if init is not None:
            raise ValueError("build_train_setup: init and live exclude each "
                             "other (a live setup's state is the state)")
        if live.device != dev:
            raise ValueError(f"build_train_setup: the live setup runs on "
                             f"{live.device}, not {dev}")
        model, state = live.model, live.state
        params, layout = state.params, live.layout
    else:
        model = build_model(cfg.network, dataset_name,
                            dtype=cfg.compute_dtype).to(dev)
        if init is None:
            init_params(model, cfg.seed)
            stats0 = init_stats(model)
        else:
            p0, stats0 = init
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(p0[name])
        params = {k: p.detach() for k, p in model.named_parameters()}
        stats = {k: (v if v.dim() == 2 else v.expand(n, -1)).to(dev).clone()
                 for k, v in stats0.items()}
        layout = params_mod.layout(model)
        state = TrainState(params=params, stats=stats,
                           opt=optim.build_optimizer_from_cfg(cfg))
        # the optimizer's buffers and count exist from the start: the
        # state's tensors keep their storage from the first step on
        state.opt.init(params)
    dim = layout.dim
    drop = model.dropout_features  # () for a model without dropout

    def loss_fn(p, st, x, y, keep):
        logits, new_st = functional_call(model, (p,), (x, st, keep))
        loss = _cross_entropy(logits, y)
        prec1 = (logits.argmax(-1) == y).float().mean()
        return loss, (new_st, prec1)

    lanes_fn = vmap(grad_and_value(loss_fn, has_aux=True),
                    in_dims=(None, 0, 0, 0, 0 if drop else None))

    def lanes(p, st, x, y, keep):
        """(lanes, B, ...) -> flat grads (lanes, d), new stats, losses,
        precs; ``keep``: each lane's dropout masks, or None."""
        with phase("draco_comp"):
            g, (loss, (new_st, prec1)) = lanes_fn(p, st, x, y, keep)
            return params_mod.flatten(g, layout, lead=1), new_st, loss, prec1

    code = build_code_from_cfg(cfg)
    decode_impl = resolve_decode_impl(cfg.decode_impl, dev)
    host_names = APPROX_HOST_NAMES if cfg.approach == "approx" else ()
    names = metric_names(cfg)
    block_names = tuple(k for k in names if k not in host_names)

    vote = cfg.approach == "maj_vote"
    # the fault plan's in-step events, on the card from setup (None: none)
    plan = faults.plan_tensors(faults.plan_from_cfg(cfg), dev)
    # the guard's approx certificate reads the host solve's bound, staged
    # beside v/n
    stage_bound = cfg.approach == "approx" and cfg.step_guard == "on"
    # a lane's key row of the step's draws: its group on maj_vote (the
    # members see the same pixels and drop the same units), else its own
    # batch row
    key_div = cfg.group_size if vote else 1

    def host_inputs(step, x, y, adv_mask, present=None):
        out, host = coded_inputs(cfg, code, step, adv_mask, present)
        return {"x": torch.as_tensor(x), "y": torch.as_tensor(y), **out}, host

    def make_chunk(start, xs, ys, masks, presents=None):
        per = [coded_inputs(cfg, code, start + i, masks[i],
                            None if presents is None else presents[i])
               for i in range(len(xs))]
        return stack_chunk(start, per, {"x": torch.as_tensor(xs),
                                        "y": torch.as_tensor(ys)},
                           (start, xs, ys, masks, presents))

    def batch(inputs):
        """The step's (n, B, ...) images, augmented, int64 labels and
        each lane's dropout masks (None without dropout), drawn on the
        device from the staged step."""
        x, y, step = inputs["x"], inputs["y"].long(), inputs["step"]
        b = x.shape[1]
        if use_aug:
            d = draws_ops.augment_draws(step, cfg.seed + draws_ops.AUG_SALT,
                                        n, b, key_div)
            x = augment_mod.augment(x, *d.unbind(0))
        keep = (draws_ops.dropout_keep(
            step, cfg.seed + draws_ops.DROPOUT_SALT, n, len(drop), b,
            drop[0], key_div) if drop else None)
        return x, y, keep

    @torch.no_grad()
    def update(state, flat_grad, new_stats, health=None, pres=None):
        """The guard's verdict, then the update gated by it (the BN
        statistics selected too); returns the guard's columns."""
        ok, cols = guards.guard_update(cfg, flat_grad, health, pres)
        with phase("draco_update"):
            state.opt.step_flat(state.params, flat_grad, layout, ok)
            for k, v in new_stats.items():
                gated(state.stats[k], v, ok)
        return cols

    def lane_metrics(losses, precs, pres):
        return {"loss": present_mean(losses, pres),
                "prec1": present_mean(precs, pres)}

    if cfg.approach == "baseline":

        def step_body(state, inputs, noise=None):
            x, y, keep = batch(inputs)
            grads, new_stats, losses, precs = lanes(state.params, state.stats,
                                                    x, y, keep)
            pres = inputs.get("present")
            grads = faults.corrupt_grads(grads, plan, inputs["step"])
            grads = attacks.inject_plain(grads, inputs["adv"], cfg.err_mode,
                                         cfg.adversarial, noise,
                                         inputs["step"], cfg.seed,
                                         n_mal=cfg.num_adversaries)
            with phase("draco_decode"):
                agg = aggregation.aggregate(grads, cfg.mode, cfg.worker_fail,
                                            cfg.geomedian_iters, pres)
            # no certificate on the robust rules: the finite check alone
            cols = update(state, agg, new_stats)
            return {**lane_metrics(losses, precs, pres), **cols}

    elif vote:

        def step_body(state, inputs, noise=None):
            x, y, keep = batch(inputs)
            with vote_lanes(dev):
                grads, new_stats, losses, precs = lanes(
                    state.params, state.stats, x, y, keep)
            mask, pres = inputs["adv"], inputs.get("present")
            grads = faults.corrupt_grads(grads, plan, inputs["step"])
            grads = attacks.inject_plain(grads, mask, cfg.err_mode,
                                         cfg.adversarial, noise,
                                         inputs["step"], cfg.seed,
                                         n_mal=cfg.num_adversaries)
            # the narrow wire: this family's wire is the gradient rows; the
            # vote reads them widened (one draw shared by every row keeps a
            # group's equal rows equal under stochastic rounding)
            rows = grads
            wire = numerics.narrow_wire_single(cfg, grads, inputs["step"])
            if wire is not None:
                rows = numerics.widen_wire_rows(wire[1], wire[0], wire[2])
            salts = draws_ops.vote_salts(inputs["step"],
                                         cfg.seed + draws_ops.VOTE_SALT)
            with phase("draco_decode"):
                voted, health = rep_mod.majority_vote(
                    code, rows, pres, salts, cfg.vote_check,
                    with_health=True)
            metrics = lane_metrics(losses, precs, pres)
            metrics["vote_agree"] = health["vote_agree"]
            metrics["flagged_groups"] = health["flagged_groups"]
            metrics.update(detection_metrics(health["flagged"], mask, pres))
            # the accused set: the out-voted rows ∪ the non-finite ingest
            # rows
            metrics.update(forensics.pack_mask_columns(
                health["flagged"] | forensics.nonfinite_rows(grads), pres,
                mask))
            if cfg.numerics_watch == "on":
                metrics.update(numerics.numerics_columns(cfg, [grads],
                                                         [rows], voted))
            if cfg.shadow_wire != "off":
                metrics.update(numerics.majvote_shadow(
                    cfg, code, grads, voted, health["flagged"], salts, pres,
                    mask, inputs["step"]))
            # the finite vote and the out-voted rows
            metrics.update(update(state, voted, new_stats,
                                  {"flagged": health["flagged"]}, pres))
            return metrics

    elif cfg.approach == "approx":
        # partial sums of the one-copy batch gradients (redundancy="shared"
        # is the only approx shape)

        def step_body(state, inputs, noise=None):
            del noise
            x, y, keep = batch(inputs)
            grads, new_stats, losses, precs = lanes(state.params, state.stats,
                                                    x, y, keep)
            pres = inputs.get("present")
            # no adversary: the schedule's row is all False
            mask = torch.zeros((n,), dtype=torch.bool, device=dev)
            grads = faults.corrupt_grads(grads, plan, inputs["step"])
            agg, health = approx_aggregate(code, grads, inputs["vn_pres"],
                                           pres is not None, cfg,
                                           inputs["step"], pres, mask)
            # the finite decode and the residual within its bound
            cols = update(state, agg, new_stats,
                          {"residual": health["residual"],
                           "bound": inputs["bound"]} if stage_bound else None,
                          pres)
            metrics = lane_metrics(losses, precs, pres)
            metrics.update(decode_health_metrics(health, mask, pres))
            metrics.update(cols)
            return metrics

    else:  # cyclic
        # the narrow wire decodes with its quantization-aware flag
        # threshold and locator λ (the tree's at its group shape); the f32
        # wire with HEALTH_REL_TOL, λ = 0
        rel_tol, wire_lam = cyclic_wire_params(cfg, code)
        if cfg.redundancy == "simulate":  # never a tree (config.validate)
            hat_s = code.hat_s
            batch_ids = torch.as_tensor(code.batch_ids, device=dev).long()
        # the reference's projection, the same vector every step: drawn
        # once, on the device
        projection = rng_mod.projection_factors(cfg.seed, dim, dev)
        # the cuts of the layer / segmented decode (None: the global
        # decode); their plan goes to the card here, before any capture
        bounds = decode_bounds(cfg, dim, layout.offsets)
        if bounds is not None:
            segment_plan(bounds, dev)

        def ingest(grads):
            """The ingest check and the grad stage's columns, before the
            encode smears a row over every codeword."""
            grad_watch = (numerics.stage_columns("grad", [grads],
                                                 cfg.shadow_block)
                          if cfg.numerics_watch == "on" else {})
            return forensics.nonfinite_rows(grads), grad_watch

        def compute_encoded(state, x, y, keep, step):
            if cfg.redundancy == "shared":
                # each batch row computed once, combined with the masked W
                grads, new_stats, losses, precs = lanes(
                    state.params, state.stats, x, y, keep)
                grads = faults.corrupt_grads(grads, plan, step)
                bad_rows, grad_watch = ingest(grads)
                with phase("draco_encode"):
                    enc_re, enc_im = encode_shared(code, grads)
                return (enc_re, enc_im, new_stats, losses, precs, bad_rows,
                        grad_watch)
            # simulate: worker i computes its hat_s batch rows, with its
            # own BN stats on each of them
            xw = x[batch_ids].flatten(0, 1)
            yw = y[batch_ids].flatten(0, 1)
            kw = None if keep is None else keep[batch_ids].flatten(0, 1)
            st = {k: v[:, None].expand(n, hat_s, v.shape[-1]).flatten(0, 1)
                  for k, v in state.stats.items()}
            grads, new_stats, losses, precs = lanes(state.params, st, xw, yw,
                                                    kw)
            grads = faults.corrupt_grads(grads.view(n, hat_s, dim), plan,
                                         step)
            # a non-finite value in any of worker i's lanes accuses worker i
            bad_rows, grad_watch = ingest(grads)
            with phase("draco_encode"):
                enc_re, enc_im = cyclic_mod.encode(code, grads)
            # fold the per-lane stats back to one set per worker
            new_stats = {k: v.view(n, hat_s, -1).mean(1)
                         for k, v in new_stats.items()}
            return (enc_re, enc_im, new_stats, losses.view(n, hat_s).mean(1),
                    precs.view(n, hat_s).mean(1), bad_rows, grad_watch)

        def step_body(state, inputs, noise=None):
            x, y, keep = batch(inputs)
            (enc_re, enc_im, new_stats, losses, precs, bad_rows,
             grad_watch) = compute_encoded(state, x, y, keep,
                                           inputs["step"])
            mask, pres = inputs["adv"], inputs.get("present")
            with phase("draco_encode"):
                enc_re, enc_im = attacks.inject_cyclic(
                    enc_re, enc_im, mask, cfg.err_mode, cfg.adversarial,
                    noise, inputs["step"], cfg.seed, cfg.num_adversaries)
                if pres is not None:
                    # a straggler's rows never arrive: zero-filled,
                    # erasures at known positions
                    pw = pres[:, None].to(enc_re.dtype)
                    enc_re, enc_im = enc_re * pw, enc_im * pw
                enc_re, enc_im, wire = numerics.narrow_wire_pair(
                    cfg, enc_re, enc_im, inputs["step"])
            with phase("draco_decode"):
                decoded, honest, health = cyclic_decode(
                    cfg, code, enc_re, enc_im, projection, bounds,
                    present=pres,
                    rel_tol=rel_tol, lam=wire_lam, wire=wire)
            metrics = lane_metrics(losses, precs, pres)
            metrics["honest_located"] = honest.sum()
            health["bad_rows"] = bad_rows
            if numerics.watch_enabled(cfg):
                # the observatory beside the f32 decode, which alone
                # feeds the update
                watch = dict(grad_watch)
                if cfg.numerics_watch == "on":
                    watch.update(numerics.stage_columns(
                        "wire", [enc_re, enc_im], cfg.shadow_block))
                    watch.update(numerics.stage_columns(
                        "agg", [decoded], cfg.shadow_block))
                if cfg.shadow_wire != "off":
                    watch.update(numerics.cyclic_shadow(
                        cfg, code, enc_re, enc_im, decoded,
                        health["flagged"], projection, layout.offsets, pres,
                        mask, inputs["step"]))
                health["watch"] = watch
            metrics.update(decode_health_metrics(health, mask, pres))
            # the finite decode, the residual and the located rows
            metrics.update(update(state, decoded, new_stats, health, pres))
            return metrics

    def train_step(state, x, y, adv_mask, noise=None, present=None):
        inputs, host = host_inputs(state.step, x, y, adv_mask, present)
        # host inputs by pinned asynchronous copies: no synchronising call
        metrics = step_body(state, {k: upload(v, dev)
                                    for k, v in inputs.items()}, noise)
        state.step += 1
        metrics.update(host)
        # the host columns take their places in the schema's order
        return state, {k: metrics[k] for k in names}

    @torch.inference_mode()
    def eval_step(state, x, y, valid):
        """The reference's ``eval_step``: worker 0's running statistics,
        no dropout, the training compute dtype."""
        from draco_tpu_torch.training.evaluator import correct_counts

        stats0 = {k: v[0] for k, v in state.stats.items()}
        return correct_counts(
            model, state.params, stats0,
            *(upload(torch.as_tensor(np.asarray(t)), dev)
              for t in (x, y, valid)))

    train_many = chunk_runner(
        f"train_many[{cfg.approach}/{cfg.redundancy}]", cfg, dev, state,
        step_body, block_names)
    return TrainSetup(model=model, state=state, train_step=train_step,
                      code=code, layout=layout, dim=dim, metric_names=names,
                      device=dev, decode_impl=decode_impl,
                      step_body=step_body,
                      block_names=block_names, make_chunk=make_chunk,
                      train_many=train_many, eval_step=eval_step)
