"""The reference's named configurations (draco_tpu/presets.py), every one
of which the port runs.

  python -m draco_tpu_torch.cli --preset cyclic-resnet18 --num-workers 8
  python -m draco_tpu_torch.cli --preset cyclic-vgg11 --max-steps 5
  python -m draco_tpu_torch.cli --preset single-lenet --max-steps 5
"""

from __future__ import annotations

import dataclasses

from draco_tpu_torch.config import TrainConfig

PRESETS: dict[str, TrainConfig] = {
    # LeNet/MNIST single-machine vanilla SGD (no coding, no adversary)
    "single-lenet": TrainConfig(
        network="LeNet", dataset="MNIST", approach="baseline", mode="normal",
        num_workers=1, worker_fail=0, batch_size=128, lr=0.01, momentum=0.9,
    ),
    # ResNet-18/CIFAR-10, repetition code r=3, no adversary
    "rep-resnet18": TrainConfig(
        network="ResNet18", dataset="Cifar10", approach="maj_vote",
        group_size=3, num_workers=9, worker_fail=0, batch_size=32,
        lr=0.01, momentum=0.9,
    ),
    # ResNet-18/CIFAR-10, cyclic code r=3 (s=1), reverse-gradient adversary
    "cyclic-resnet18": TrainConfig(
        network="ResNet18", dataset="Cifar10", approach="cyclic",
        num_workers=9, worker_fail=1, err_mode="rev_grad", batch_size=32,
        lr=0.01, momentum=0.9,
    ),
    # VGG-11/CIFAR-10, cyclic code r=5 (s=2), constant attack (the
    # reference's "random" mode is a passthrough, model_ops/utils.py:20-21)
    "cyclic-vgg11": TrainConfig(
        network="VGG11", dataset="Cifar10", approach="cyclic",
        num_workers=9, worker_fail=2, err_mode="constant", batch_size=32,
        lr=0.01, momentum=0.9,
    ),
    # the robust-aggregation baselines under the same adversary schedule
    "geomedian-resnet18": TrainConfig(
        network="ResNet18", dataset="Cifar10", approach="baseline",
        mode="geometric_median", num_workers=9, worker_fail=1,
        err_mode="rev_grad", batch_size=32, lr=0.01, momentum=0.9,
    ),
    "krum-resnet18": TrainConfig(
        network="ResNet18", dataset="Cifar10", approach="baseline",
        mode="krum", num_workers=9, worker_fail=1, err_mode="rev_grad",
        batch_size=32, lr=0.01, momentum=0.9,
    ),
    # the straggler scenario: the approximate code at r=1.5, dimensioned
    # for up to ⌈0.25·n⌉ absent workers a step, 2 dropped each step, no
    # live adversary
    "approx-resnet18": TrainConfig(
        network="ResNet18", dataset="Cifar10", approach="approx",
        num_workers=9, worker_fail=0, redundancy="shared",
        code_redundancy=1.5, straggler_alpha=0.25,
        straggle_mode="drop", straggle_count=2, batch_size=32,
        lr=0.01, momentum=0.9,
    ),
}


def get_preset(name: str, **overrides) -> TrainConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r} (have {sorted(PRESETS)})")
    return dataclasses.replace(PRESETS[name], **overrides).validate()
