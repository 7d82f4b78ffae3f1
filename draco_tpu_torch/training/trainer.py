"""The eager training loop (draco_tpu/training/trainer.py, one step per
call).

Batches come from the reference's deterministic index streams
(``indices_cyclic`` for the coded path, ``indices_baseline`` otherwise) for
1-based step t at index t − 1; the adversary mask of step t is row t of the
seeded schedule. Each step's metrics are synchronised to the host and every
``log_every``-th (and the first) goes to ``<train_dir>/metrics.jsonl`` under
the reference's column names.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from draco_tpu_torch import rng as drng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching
from draco_tpu_torch.data.datasets import Dataset, load_dataset
from draco_tpu_torch.runtime import resolve_device
from draco_tpu_torch.training.step import build_train_setup


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

    def batch(self, step: int):
        """(n, B, H, W, C) images and (n, B) labels of 1-based ``step``."""
        cfg = self.cfg
        pick = (batching.indices_baseline if cfg.approach == "baseline"
                else batching.indices_cyclic)
        idx = pick(len(self.ds), step - 1, cfg.num_workers, cfg.batch_size,
                   cfg.seed)
        return batching.gather(self.ds, idx, cfg.num_workers, cfg.batch_size)

    def step(self) -> dict:
        """Run the next step; returns its metrics as floats, with the wall
        time of the step (host clock, device synchronised) as ``step_ms``."""
        step = self.state.step
        if step > self.cfg.max_steps:
            raise ValueError(f"step {step} is past max_steps="
                             f"{self.cfg.max_steps}")
        x, y = self.batch(step)
        t0 = time.perf_counter()
        self.state, metrics = self.setup.train_step(
            self.state, x, y, self.adv_schedule[step])
        # .item() waits for the device: the step's work is all on one stream
        out = {k: float(metrics[k].item()) for k in self.setup.metric_names}
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        return {"step": step, **out}

    def run(self, max_steps: Optional[int] = None) -> dict:
        """Steps up to ``max_steps`` (default cfg.max_steps); returns the
        last step's record."""
        cfg = self.cfg
        last_step = cfg.max_steps if max_steps is None else max_steps
        path = (os.path.join(cfg.train_dir, "metrics.jsonl")
                if cfg.train_dir else None)
        if path:
            os.makedirs(cfg.train_dir, exist_ok=True)
        last = {}
        while self.state.step <= last_step:
            last = self.step()
            step = last["step"]
            if step % cfg.log_every == 0 or step == 1:
                if path:
                    with open(path, "a") as f:
                        f.write(json.dumps(last) + "\n")
                if not self.quiet:
                    print(" ".join(f"{k}={v:.6g}" if isinstance(v, float)
                                   else f"{k}={v}" for k, v in last.items()),
                          flush=True)
        return last
