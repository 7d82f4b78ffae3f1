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

The eager loop (K = 1) synchronises each step's metrics to the host; its
``step_ms`` is the step's wall time. The chunked loop (K > 1,
``_run_chunked``) runs chunks of up to K steps (``batching.chunk_ranges``,
snapped to ``eval_freq``) through ``setup.train_many`` — on the card one
captured CUDA graph replayed — driven by ``control.engine.ChunkedEngine``:
the next chunk's batches are gathered on a worker thread
(``data/prefetch.py``) and assembled while the card runs the current one,
and the metrics reach the host once a flush; a chunked record's
``step_ms`` is its flush window's wall time over its steps. With
``cfg.trace_dir`` set, the host phases (gather, dispatch, sync, flush) and
the step's draco_* phases go to ``trace_dir/trace.json``
(``obs/tracer.py``).
"""

from __future__ import annotations

import time
from typing import Optional

from draco_tpu_torch import rng as drng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching
from draco_tpu_torch.data.datasets import Dataset, load_dataset
from draco_tpu_torch.obs.tracer import make_tracer
from draco_tpu_torch.runtime import resolve_device
from draco_tpu_torch.training.step import build_train_setup
from draco_tpu_torch.utils.metrics import MetricWriter


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None,
                 dataset: Optional[Dataset] = None, quiet: bool = False):
        self.cfg = cfg.validate()
        resolve_device(device)  # raise before loading data when cuda is absent
        self.ds = dataset if dataset is not None else load_dataset(
            cfg.dataset, cfg.data_dir)
        self.setup = build_train_setup(cfg, device, dataset_name=self.ds.name)
        self.state = self.setup.state
        self.quiet = quiet
        self.adv_schedule = drng.adversary_schedule(
            cfg.seed, cfg.max_steps, cfg.num_workers, cfg.num_adversaries)
        self.straggle_schedule = (
            drng.straggler_schedule(cfg.seed, cfg.max_steps,
                                    cfg.num_workers, cfg.straggle_count)
            if cfg.straggle_mode == "drop" and cfg.straggle_count > 0
            else None)
        self.tracer = make_tracer(cfg.trace_dir)
        self.group_seeds = drng.group_seeds(cfg.seed, max(cfg.num_groups, 1))

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
        x, y = self.batch(step)
        present = (None if self.straggle_schedule is None
                   else ~self.straggle_schedule[step])
        return x, y, self.adv_schedule[step], present

    def step(self) -> dict:
        """Run the next step eagerly; returns its metrics as floats, with
        the wall time of the step (host clock, device synchronised) as
        ``step_ms``."""
        step = self.state.step
        if step > self.cfg.max_steps:
            raise ValueError(f"step {step} is past max_steps="
                             f"{self.cfg.max_steps}")
        tracer = self.tracer
        with tracer.span("gather"):
            x, y, adv_mask, present = self.inputs(step)
        t0 = time.perf_counter()
        with tracer.span("dispatch"), tracer.activate():
            self.state, metrics = self.setup.train_step(
                self.state, x, y, adv_mask, present=present)
        # .item() waits for the device: the step's work is all on one stream
        with tracer.span("sync"):
            out = {k: float(metrics[k].item())
                   for k in self.setup.metric_names}
        if present is not None:
            out["present"] = float(present.sum())
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        return {"step": step, **out}

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
        """The engine's client for steps [first, last] over a fresh batch
        prefetcher."""
        from draco_tpu_torch.control.clients import TrainerChunkClient
        from draco_tpu_torch.data import prefetch as pf

        cfg = self.cfg
        prefetch = pf.ChunkPrefetcher(
            self.ds, self.chunk_indices, cfg.num_workers, cfg.batch_size,
            timeout_s=pf.STALL_TIMEOUT_S, tracer=self.tracer)
        return TrainerChunkClient(self, prefetch, first, last)

    def _run_chunked(self, last_step: int, writer: MetricWriter) -> dict:
        from draco_tpu_torch.control.engine import ChunkedEngine

        client = self.chunk_client(self.state.step, last_step)
        engine = ChunkedEngine(client, eval_freq=self.cfg.eval_freq,
                               tracer=self.tracer, writer=writer)
        self.state, last = engine.run(self.state, client.ranges)
        return last

    def run(self, max_steps: Optional[int] = None) -> dict:
        """Steps up to ``max_steps`` (default cfg.max_steps), eagerly or in
        chunks by ``cfg.steps_per_call``; returns the last step's
        record."""
        cfg = self.cfg
        last_step = cfg.max_steps if max_steps is None else max_steps
        writer = MetricWriter(cfg.train_dir, self.quiet)
        try:
            if cfg.steps_per_call > 1:
                return self._run_chunked(last_step, writer)
            last = {}
            while self.state.step <= last_step:
                last = self.step()
                step = last["step"]
                if step % cfg.log_every == 0 or step == 1:
                    with self.tracer.span("flush"):
                        writer.write(last)
            return last
        finally:
            self.tracer.close()
