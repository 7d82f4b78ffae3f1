"""The CNN training loop (draco_tpu/training/trainer.py): one step a call,
or K-step chunks at ``steps_per_call`` K > 1.

Batches come from the reference's deterministic index streams
(``indices_cyclic`` for the cyclic and approx codes, ``indices_grouped``
for the repetition code, ``indices_baseline`` for the baseline) for
1-based step t at index t − 1; the adversary mask of step t is row t of the
seeded schedule, and under ``straggle_mode="drop"`` the step's presence
mask is the negation of row t of the straggler schedule (a ``present``
column then counts the arrived rows). The first and every
``log_every``-th record go to ``<train_dir>/metrics.jsonl`` under the
reference's column names.

At every ``eval_freq`` boundary the loop evaluates the whole test split
(``evaluate``: ``{"step", "prec1_test", "prec5_test"}``, sample-weighted,
``training/evaluator.py``) and then, with a ``train_dir``, checkpoints
the state there (``model_step_k.dcg``, ``utils/checkpoint.py``), as the
reference does. ``cfg.checkpoint_step`` resumes: k from step k's
checkpoint, −1 from the newest loadable one (``restore``, walking back
past corrupt ones); the loop then runs on to ``max_steps``, and a later
``run(max_steps=)`` continues from where the last stopped. ``run`` sits
inside ``GracefulStop`` (``training/run_state.py``): SIGTERM stops at the
next step or chunk end with a checkpoint there, a second signal
checkpoints the newest state at once.

The eager loop (K = 1) synchronises each step's metrics to the host; its
``step_ms`` is the step's wall time. The chunked loop (K > 1,
``_run_chunked``) runs chunks of up to K steps (``batching.chunk_ranges``,
snapped to ``eval_freq``) through ``setup.train_many`` — on the card one
captured CUDA graph replayed — driven by ``control.engine.ChunkedEngine``:
the next chunk's batches are gathered on a worker thread
(``data/prefetch.py``, supervised: ``cfg.prefetch_restarts``,
``cfg.prefetch_timeout_s``) and assembled while the card runs the current
one, and the metrics reach the host once a flush; a chunked record's
``step_ms`` is its flush window's wall time over its steps. With
``cfg.trace_dir`` set, the host phases (gather, dispatch, sync, flush,
eval, ckpt) and the step's draco_* phases go to ``trace_dir/trace.json``
(``obs/tracer.py``).

With a ``train_dir`` the run heartbeat (``obs/heartbeat.py``) keeps
``train_dir/status.json``: it observes every record the loop
materialises (each eager step's; each record of a chunked flush), beats
at each flush (the chunked loop's) or at an ``eval_freq`` boundary and
the last step (the eager loop's), carries the run's wire ledger, and ends
``done``, ``preempted`` or ``crashed`` (``training/run_state.py``). Mask
columns come to the host as their exact integer words
(``obs/forensics.record_value``). With ``incident_watch="on"`` the
heartbeat feeds the incident engine (``obs/incidents.make_engine``), which
writes ``train_dir/incidents.jsonl`` and the status.json incidents block.

The seeded fault plan (``cfg.fault_spec``, ``resilience/faults.py``): its
over_budget and adversary events overlay the adversary schedule, its
straggle events the straggler schedule (a fresh all-present one when the
configuration drops none), each time the schedules are made, past
``max_steps`` too; its host events wrap the loaders' data functions
(``prefetch_crash`` / ``prefetch_hang``, retried by the supervised
prefetcher) and come with the stop polls (``sigterm``); its in-step events
run inside the step (``training/step.py``).

With ``cfg.autopilot="on"`` (``control/autopilot.py``; the chunked loop
only) the Trainer makes an all-present straggler schedule when the
configuration drops none, up front: the autopilot quarantines a worker by
writing that schedule, and a graph captured without a ``present`` staging
buffer could never gain one. The autopilot is built once
(``_make_autopilot``) and kept across ``run()`` calls, with its regime,
its cached regime setups and its quarantines; a regenerated schedule gets
the active quarantines stamped on again (``reapply_quarantines``).
"""

from __future__ import annotations

import time
from typing import Optional

from draco_tpu_torch import rng as drng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching
from draco_tpu_torch.data.datasets import Dataset, load_dataset
from draco_tpu_torch.obs import incidents, numerics
from draco_tpu_torch.obs.forensics import record_value
from draco_tpu_torch.obs.heartbeat import RunHeartbeat
from draco_tpu_torch.obs.tracer import make_tracer
from draco_tpu_torch.resilience.supervisor import shielded
from draco_tpu_torch.runtime import resolve_device
from draco_tpu_torch.training.evaluator import masked_full_split_eval
from draco_tpu_torch.training.run_state import LoopRunState
from draco_tpu_torch.training.step import build_train_setup
from draco_tpu_torch.utils.metrics import MetricWriter


class Trainer(LoopRunState):
    def __init__(self, cfg: TrainConfig, device=None,
                 dataset: Optional[Dataset] = None, quiet: bool = False):
        self.cfg = cfg.validate()
        resolve_device(device)  # raise before loading data when cuda is absent
        self.ds = dataset if dataset is not None else load_dataset(
            cfg.dataset, cfg.data_dir)
        self.setup = build_train_setup(cfg, device, dataset_name=self.ds.name)
        self.state = self.setup.state
        self.quiet = quiet
        self.writer = MetricWriter(cfg.train_dir, quiet)
        self.tracer = make_tracer(cfg.trace_dir)
        self.heartbeat = RunHeartbeat(cfg.train_dir or None,
                                      num_workers=cfg.num_workers,
                                      job_name=cfg.job_name or None,
                                      incidents=incidents.make_engine(cfg))
        self.heartbeat.set_wire(numerics.wire_ledger(cfg, self.setup.dim))
        self.init_resilience()
        self._eager_batch = self.eager_source(self.batch)
        self.group_seeds = drng.group_seeds(cfg.seed, max(cfg.num_groups, 1))
        self._sched_steps = -1
        self._ensure_schedules(cfg.max_steps)
        self._prefetch = None  # the running chunk client's prefetcher
        if cfg.checkpoint_step:
            self.restore(cfg.checkpoint_step)

    def _ensure_schedules(self, n_steps: int) -> None:
        """The adversary and straggler tables through step ``n_steps``
        (regenerated longer for a ``run(max_steps=)`` past them; each row
        takes a fixed draw, so the rows already used stay as they were)."""
        if n_steps <= self._sched_steps:
            return
        cfg = self.cfg
        self.adv_schedule = self.overlay_adversaries(drng.adversary_schedule(
            cfg.seed, n_steps, cfg.num_workers, cfg.num_adversaries))
        self.straggle_schedule = self.straggle_table(n_steps)
        self._sched_steps = n_steps

    def batch(self, step: int):
        """(n, B, H, W, C) images and (n, B) labels of 1-based ``step``."""
        cfg = self.cfg
        n = len(self.ds)
        if cfg.approach == "baseline":
            idx = batching.indices_baseline(n, step - 1, cfg.num_workers,
                                            cfg.batch_size, cfg.seed)
        elif cfg.approach == "maj_vote":
            idx = batching.indices_grouped(n, step - 1, cfg.num_workers,
                                           cfg.group_size, cfg.batch_size,
                                           self.group_seeds)
        else:
            idx = batching.indices_cyclic(n, step - 1, cfg.num_workers,
                                          cfg.batch_size, cfg.seed)
        return batching.gather(self.ds, idx, cfg.num_workers, cfg.batch_size)

    def inputs(self, step: int) -> tuple:
        """The host inputs of 1-based ``step``: ``(x, y, adv_mask,
        present)`` as ``setup.train_step`` takes them."""
        x, y = self._eager_batch(step)
        present = (None if self.straggle_schedule is None
                   else ~self.straggle_schedule[step])
        return x, y, self.adv_schedule[step], present

    def step(self) -> dict:
        """Run the next step eagerly; returns its metrics as floats, with
        the wall time of the step (host clock, device synchronised) as
        ``step_ms``."""
        step = self.state.step
        if step > self._sched_steps:
            raise ValueError(f"step {step} is past the schedules' "
                             f"{self._sched_steps} steps (max_steps)")
        tracer = self.tracer
        with tracer.span("gather"):
            x, y, adv_mask, present = self.inputs(step)
        t0 = time.perf_counter()
        with tracer.span("dispatch"), tracer.activate():
            self.state, metrics = self.setup.train_step(
                self.state, x, y, adv_mask, present=present)
        # .item() waits for the device: the step's work is all on one stream
        with tracer.span("sync"):
            out = {k: record_value(k, metrics[k])
                   for k in self.setup.metric_names}
        if present is not None:
            out["present"] = float(present.sum())
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        return {"step": step, **out}

    # ---- eval ----------------------------------------------------------
    def evaluate(self, step: int, batch_size: Optional[int] = None) -> dict:
        """Accuracy on the whole test split at ``batch_size`` (default
        ``cfg.test_batch_size``; the ragged last batch padded and masked),
        written as ``{"step", "prec1_test", "prec5_test"}``."""
        with self.tracer.span("eval", at_step=step):
            p1, p5 = masked_full_split_eval(
                lambda x, y, valid: self.setup.eval_step(self.state, x, y,
                                                         valid),
                self.ds.test_x, self.ds.test_y,
                batch_size or self.cfg.test_batch_size)
        rec = {"step": step, "prec1_test": p1, "prec5_test": p5}
        self.writer.write(rec)
        return rec

    # ---- chunking ------------------------------------------------------
    def chunk_indices(self, start: int, k: int):
        """(k, n·B) flat sample indices of 1-based steps [start, start+k):
        row i equals step start + i's indices bit for bit."""
        cfg = self.cfg
        n = len(self.ds)
        if cfg.approach == "baseline":
            return batching.indices_baseline_range(
                n, start - 1, k, cfg.num_workers, cfg.batch_size, cfg.seed)
        if cfg.approach == "maj_vote":
            return batching.indices_grouped_range(
                n, start - 1, k, cfg.num_workers, cfg.group_size,
                cfg.batch_size, self.group_seeds)
        return batching.indices_cyclic_range(
            n, start - 1, k, cfg.num_workers, cfg.batch_size, cfg.seed)

    def chunk_client(self, first: int, last: int):
        """The engine's client for steps [first, last] over a fresh,
        supervised batch prefetcher."""
        from draco_tpu_torch.control.clients import TrainerChunkClient
        from draco_tpu_torch.data import prefetch as pf

        cfg = self.cfg
        self._ensure_schedules(last)
        indices = self.injector.wrap_range_fn(self.chunk_indices)
        self._prefetch = self.supervised(lambda: pf.ChunkPrefetcher(
            self.ds, indices, cfg.num_workers, cfg.batch_size,
            timeout_s=cfg.prefetch_timeout_s, tracer=self.tracer))
        return TrainerChunkClient(self, self._prefetch, first, last)

    def _run_chunked(self, last_step: int) -> dict:
        from draco_tpu_torch.control.engine import ChunkedEngine

        client = self.chunk_client(self.state.step, last_step)
        engine = ChunkedEngine(client, eval_freq=self.cfg.eval_freq,
                               tracer=self.tracer, writer=self.writer,
                               stop=self._stop, heartbeat=self.heartbeat,
                               total_end=last_step, injector=self.injector,
                               autopilot=self._make_autopilot())
        self.state, last = engine.run(self.state, client.ranges)
        return last

    def _run_eager(self, last_step: int) -> dict:
        cfg, last = self.cfg, {}
        while self.state.step <= last_step:
            with shielded(self._stop):
                last = self.step()
            step = last["step"]
            self.heartbeat.observe(last)
            if step % cfg.log_every == 0 or step == 1:
                with self.tracer.span("flush"):
                    self.writer.write(last)
            boundary = bool(cfg.eval_freq) and step % cfg.eval_freq == 0
            if boundary or step == last_step:
                self.heartbeat.beat(step, last_step)
            if boundary:
                self.boundary(step)
            if self.stop_after(step, already_saved=boundary):
                break
        return last

    def run(self, max_steps: Optional[int] = None) -> dict:
        """Steps up to ``max_steps`` (default cfg.max_steps), eagerly or in
        chunks by ``cfg.steps_per_call``, from the state's next step;
        returns the last step's record ({} after an escalated stop)."""
        last_step = self.cfg.max_steps if max_steps is None else max_steps
        self._ensure_schedules(last_step)
        if self.cfg.steps_per_call > 1:
            return self.guarded(lambda: self._run_chunked(last_step))
        return self.guarded(lambda: self._run_eager(last_step))

    def close(self) -> None:
        """Close a prefetcher a run left open, and the tracer."""
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None
        self.tracer.close()
