"""Experiment configuration — the slice of ``draco_tpu.config.TrainConfig``
the port runs.

Field names and defaults are the reference's. ``validate()`` keeps the
reference's checks on these fields and rejects, with a clear error, every
value the port does not implement yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Deterministic seed shared by every participant (reference: SEED_=428).
SEED = 428

AGG_MODES = ("normal", "geometric_median")
NETWORKS = ("ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152")
ERR_MODES = ("rev_grad", "constant", "random")


@dataclasses.dataclass
class TrainConfig:
    # --- model / data ---
    network: str = "LeNet"
    dataset: str = "MNIST"
    data_dir: str = "./data"
    batch_size: int = 128  # per-worker batch size
    # --- optimization: SGD with momentum ---
    lr: float = 0.01
    momentum: float = 0.9
    max_steps: int = 10000
    # --- coded data parallelism ---
    num_workers: int = 8
    approach: str = "baseline"  # baseline | cyclic
    mode: str = "normal"  # baseline aggregation: normal | geometric_median
    worker_fail: int = 0  # s
    err_mode: str = "rev_grad"  # rev_grad | constant | random
    adversarial: float = -100.0
    adversary_count: Optional[int] = None  # None = worker_fail
    redundancy: str = "simulate"  # simulate | shared
    decode_granularity: str = "global"
    decode_impl: str = "auto"  # auto | pallas: kernel on cuda, plain on cpu
    # --- options of the reference the port rejects for now ---
    wire_dtype: str = "f32"
    wire_segments: int = 1
    topology: str = "flat"
    # --- run ---
    train_dir: str = "./train_out/"
    log_every: int = 10
    seed: int = SEED
    geomedian_iters: int = 80

    @property
    def s(self) -> int:
        return self.worker_fail

    @property
    def hat_s(self) -> int:
        return 2 * self.worker_fail + 1

    @property
    def num_adversaries(self) -> int:
        return (self.worker_fail if self.adversary_count is None
                else self.adversary_count)

    def validate(self) -> "TrainConfig":
        if self.approach not in ("baseline", "cyclic"):
            raise ValueError(
                f"approach={self.approach!r} is not ported yet (the port "
                f"runs baseline|cyclic)")
        if self.approach == "baseline" and self.mode not in AGG_MODES:
            raise ValueError(
                f"baseline mode={self.mode!r} is not ported yet (the port "
                f"runs {'|'.join(AGG_MODES)})")
        if self.network not in NETWORKS:
            raise ValueError(
                f"network={self.network!r} is not ported yet (the port runs "
                f"{'|'.join(NETWORKS)})")
        if self.err_mode not in ERR_MODES:
            raise ValueError(
                f"err_mode={self.err_mode!r} is not ported yet (the port "
                f"runs {'|'.join(ERR_MODES)})")
        if self.redundancy not in ("simulate", "shared"):
            raise ValueError(f"unknown redundancy: {self.redundancy!r}")
        if self.decode_granularity != "global":
            raise ValueError(
                "decode_granularity='layer' is not ported yet (the port "
                "decodes globally)")
        if self.decode_impl not in ("auto", "pallas"):
            raise ValueError(
                f"decode_impl={self.decode_impl!r} is not ported (auto|pallas:"
                f" the kernels on cuda, their plain versions on cpu)")
        if self.wire_dtype != "f32":
            raise ValueError(
                f"wire_dtype={self.wire_dtype!r} is not ported yet (f32 only)")
        if self.wire_segments != 1:
            raise ValueError("wire_segments > 1 is not ported yet")
        if self.topology != "flat":
            raise ValueError(f"topology={self.topology!r} is not ported yet")
        if self.approach == "cyclic" and self.num_workers <= 4 * self.worker_fail:
            raise ValueError(
                f"cyclic code needs n > 4s (got n={self.num_workers}, "
                f"s={self.worker_fail})")
        if self.worker_fail > self.num_workers:
            raise ValueError("worker_fail cannot exceed num_workers")
        if self.adversary_count is not None and not (
                0 <= self.adversary_count <= self.worker_fail):
            raise ValueError(
                "adversary_count must lie in [0, worker_fail] (the code is "
                f"only built to tolerate worker_fail={self.worker_fail})")
        if self.batch_size < 1 or self.num_workers < 1:
            raise ValueError("batch_size and num_workers must be >= 1")
        return self
