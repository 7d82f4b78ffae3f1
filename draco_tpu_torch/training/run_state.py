"""What the CNN ``Trainer`` and the LM ``TokenLoop`` share of a run's
state (draco_tpu/training/trainer.py and parallel/token_loop.py): the
checkpoint at an ``eval_freq`` boundary, the resume, and the graceful
stop.

  checkpoint(step)   the state as ``model_step_{step}.dcg`` in
                     ``cfg.train_dir`` (nothing without one), read after
                     the work queued on the current stream, which a
                     captured chunk replays on: no copy races a replay
  restore(step)      the checkpoint at ``step`` (the newest with −1)
                     through the walk-back, written into the live state in
                     place (``TrainState.load``); −1 on a train_dir with
                     no checkpoint starts fresh
  guarded(body, profile_dir, profile_steps)
                     runs ``body(window)`` inside ``GracefulStop``, with
                     the run's profiler window (``obs/profiling.py``),
                     stopped before the terminal status write, and the
                     loop's ``compile_watch`` started; a first
                     SIGTERM / SIGINT stops the loop at its next step or
                     chunk end (``stop_after``), with a checkpoint there
                     unless the boundary just saved one; a second one
                     checkpoints the newest dispatched state and ends the
                     run. ``stopped_step`` is where the run stopped (None
                     when it ran to its end). The run's status.json then
                     ends ``done``, ``preempted`` (with ``resumable_step``
                     when a checkpoint was saved) or, on any other
                     exception, ``crashed`` with its cause, before the
                     exception propagates.

``init_resilience()`` sets up what both loops share of the fault plan
(``resilience/faults.py``): the parsed plan, its host injector (whose
``sigterm`` events the stop polls deliver) and the overlays of the
adversary schedule; ``straggle_table(n_steps)`` the straggler schedule
with the plan's straggle events on it (``faults.apply_straggle``) — under
``autopilot="on"`` an all-present one when the configuration drops
none, with the autopilot's active quarantines stamped on again;
``_make_autopilot()`` the run's autopilot (``control/autopilot.py``), built
once and kept across ``run()`` calls; ``eager_source(fn)`` the eager
loop's data function wrapped by the injector and supervised (a
``prefetch_crash`` is retried), ``fn`` itself without host events.

The loop provides ``cfg``, ``setup`` (its ``layout`` and ``device``),
``state``, ``tracer``, ``writer``, ``heartbeat``
(``obs/heartbeat.RunHeartbeat``), ``compile_watch``
(``obs/compile_watch.CompileWatch``) and ``evaluate(step)``, and
dispatches its steps and chunks inside ``supervisor.shielded(self._stop)``:
a second signal's escalation waits until the state is a whole step's.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from draco_tpu_torch import rng as drng
from draco_tpu_torch.obs.profiling import profiler_window
from draco_tpu_torch.resilience import faults
from draco_tpu_torch.resilience.supervisor import (
    DirectSource,
    GracefulStop,
    ImmediateStopError,
    SupervisedPrefetcher,
    restore_with_walkback,
    stop_requested,
)
from draco_tpu_torch.utils import checkpoint as ckpt


class LoopRunState:
    _stop: Optional[GracefulStop] = None
    stopped_step: Optional[int] = None
    fault_plan: Optional[faults.FaultPlan] = None
    injector = faults.NULL_INJECTOR
    _autopilot = None  # control/autopilot.Autopilot, when on

    def init_resilience(self) -> None:
        """The fault plan of ``cfg.fault_spec`` (None without one) and its
        host injector."""
        self.fault_plan = faults.plan_from_cfg(self.cfg)
        self.injector = faults.HostFaultInjector(self.fault_plan)

    def overlay_adversaries(self, adv):
        """The seeded adversary table with the plan's over_budget and
        adversary events on it (a copy; ``adv`` itself without them)."""
        return faults.apply_adversary(
            faults.apply_over_budget(adv, self.fault_plan,
                                     self.cfg.worker_fail),
            self.fault_plan)

    def straggle_table(self, n_steps: int) -> Optional[np.ndarray]:
        """The (n_steps + 1, n) straggler table (True = absent), or None
        when every row arrives. Each row takes a fixed draw, so a longer
        table keeps the rows already used. Under ``autopilot="on"`` the
        table exists from the start, all present when the configuration
        drops none: the autopilot quarantines a worker by writing it, and
        a graph captured without a ``present`` staging buffer could never
        gain one."""
        cfg = self.cfg
        table = faults.apply_straggle(
            drng.straggler_schedule(cfg.seed, n_steps, cfg.num_workers,
                                    cfg.straggle_count)
            if cfg.straggle_mode == "drop" and cfg.straggle_count > 0
            else None, self.fault_plan, cfg.num_workers, n_steps)
        if cfg.autopilot == "on":
            if table is None:
                table = np.zeros((n_steps + 1, cfg.num_workers), dtype=bool)
            if self._autopilot is not None:
                # a new table must not readmit a worker still held out
                self._autopilot.reapply_quarantines(table)
        return table

    def _make_autopilot(self):
        """The run's autopilot (None unless ``cfg.autopilot="on"``), built
        once: its regime, its cached regime setups and its quarantines
        outlive a ``run()``."""
        if self._autopilot is None and self.cfg.autopilot == "on":
            from draco_tpu_torch.control.autopilot import make_autopilot

            self._autopilot = make_autopilot(self.cfg, self.heartbeat,
                                             dim=self.setup.dim)
        return self._autopilot

    def eager_source(self, fn: Callable):
        """``step -> data`` for the eager loop: ``fn`` wrapped by the
        injector behind a supervised direct source when the plan has host
        events, else ``fn``."""
        if not self.injector.active:
            return fn
        source = self.supervised(
            lambda: DirectSource(self.injector.wrap_step_fn(fn)))
        return source.get

    def checkpoint(self, step: int) -> Optional[str]:
        """Save the state as step ``step``'s checkpoint; the path, or None
        without a train_dir."""
        cfg = self.cfg
        if not cfg.train_dir:
            return None
        with self.tracer.span("ckpt", at_step=step):
            return ckpt.save(cfg.train_dir, step,
                             self.state.arrays(self.setup.layout),
                             compress=cfg.compress_ckpt,
                             keep=cfg.keep_checkpoints,
                             tree=self._tree_names())

    def restore(self, step: int) -> Optional[int]:
        """Resume from ``step`` (−1: the newest loadable checkpoint); the
        step loaded, or None on a fresh start."""
        lay = self.setup.layout

        def load(train_dir, s, specs):
            # a tree of other names is refused before its leaves are read
            ckpt.check_tree(train_dir, s, self._tree_names())
            return ckpt.load(train_dir, s, specs)

        try:
            arrays, loaded, _ = restore_with_walkback(
                self.cfg.train_dir, step, self.state.specs(lay), load)
        except ckpt.LeafCountError as e:
            # the LM's two layer layouts hold different trees
            # (models/transformer.py): refused, never restacked
            scan = getattr(self.setup.model, "scan_layers", None)
            if scan is None or e.count != self._other_layout_leaves(scan):
                raise
            held = ("stacked (scan_layers=True)" if scan
                    else "unrolled (scan_layers=False)")
            raise ValueError(
                f"{e}: this run's LM keeps its blocks {held}; the "
                f"checkpoint's count is the other layer layout's, which is "
                f"not interchangeable with it and is not restacked") from e
        except FileNotFoundError:
            if step != -1:
                raise
            # -1 is the restart controller's "whatever is there": a job
            # that died before its first checkpoint starts fresh
            print(f"checkpoint_step=-1: no checkpoints in "
                  f"{self.cfg.train_dir!r}; starting fresh", flush=True)
            return None
        self.state.load(arrays, lay)
        return loaded

    def _tree_names(self) -> tuple:
        """The names a checkpoint of this run carries beside it: the LM's
        parameters (its trees differ by route and layer layout with the
        same leaves), none for a CNN."""
        from draco_tpu_torch.config import LM_NETWORK

        return (self.setup.layout.names if self.cfg.network == LM_NETWORK
                else ())

    def _other_layout_leaves(self, scan: bool) -> int:
        """The leaf count of this LM's state in the other layer layout
        (built on meta, nothing allocated)."""
        import torch

        from draco_tpu_torch import optim, params as params_mod
        from draco_tpu_torch.models.transformer import TransformerLM
        from draco_tpu_torch.training.step import TrainState

        cfg = self.cfg
        with torch.device("meta"):
            model = TransformerLM(cfg.vocab, cfg.model_dim, cfg.model_heads,
                                  cfg.model_layers, scan_layers=not scan,
                                  experts=cfg.moe_experts)
        params = {k: p.detach() for k, p in model.named_parameters()}
        state = TrainState(params=params, stats={},
                           opt=optim.build_optimizer_from_cfg(cfg))
        state.opt.init(params)
        return len(state.specs(params_mod.layout(model)))

    def boundary(self, step: int) -> None:
        """The ``eval_freq`` boundary: evaluate, then checkpoint."""
        self.evaluate(step)
        self.checkpoint(step)

    def supervised(self, factory: Callable):
        """The chunked loop's prefetcher: ``factory()``, rebuilt on failure
        up to ``cfg.prefetch_restarts`` times a request."""
        if self.cfg.prefetch_restarts <= 0:
            return factory()
        return SupervisedPrefetcher(factory,
                                    restarts=self.cfg.prefetch_restarts,
                                    tracer=self.tracer)

    def stop_after(self, step: int, already_saved: bool) -> bool:
        """True when a stop was asked for: the run then ends after
        ``step``, with a checkpoint there (unless ``already_saved``)."""
        if not stop_requested(self._stop, self.injector, step):
            return False
        if not already_saved:
            self.checkpoint(step)
        self.stopped_step = step
        self._stop.stopped_step = step
        return True

    def guarded(self, body: Callable, profile_dir: Optional[str] = None,
                profile_steps: tuple = (3, 8)) -> dict:
        """``body(window)`` (the loop's steps) inside ``GracefulStop``, with
        the run's profiler window (``obs/profiling.py``; the no-op window
        without ``profile_dir``), stopped before the terminal status write
        so the ``device`` block rides it, and the compile watch started;
        returns its last record, or {} after an escalated stop."""
        self.stopped_step = None
        first = self.state.step
        hb = self.heartbeat
        self.compile_watch.start()
        window = profiler_window(profile_dir, profile_steps,
                                 tracer=self.tracer,
                                 on_stop=hb.observe_device,
                                 device=self.setup.device)
        try:
            with GracefulStop() as stop:
                self._stop = stop
                try:
                    last = body(window)
                finally:
                    window.stop()  # a run that ended inside the window
        except ImmediateStopError as e:
            # the newest dispatched state is whole (dispatches are
            # shielded); reading it waits for its queued work
            step = self.state.step - 1
            saved = None
            if step >= first:
                saved = self.checkpoint(step)
                self.stopped_step = step
            print(f"{e}: stopped after step {step}", flush=True)
            hb.terminal("preempted", cause=str(e),
                        resumable_step=step if saved else None)
            return {}
        except BaseException as e:
            hb.terminal("crashed", cause=f"{type(e).__name__}: {e}")
            raise
        finally:
            self._stop = None
            self.compile_watch.stop()
            self.tracer.close()
        if self.stopped_step is not None:
            hb.terminal("preempted", cause=f"graceful stop on {stop.signame}",
                        resumable_step=(self.stopped_step
                                        if self.cfg.train_dir else None))
        else:
            hb.terminal("done")
        return last
