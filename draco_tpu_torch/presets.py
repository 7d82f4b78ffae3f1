"""The reference's named configurations the port runs (draco_tpu/presets.py).

  python -m draco_tpu_torch.cli --preset cyclic-resnet18 --num-workers 8
"""

from __future__ import annotations

import dataclasses

from draco_tpu_torch.config import TrainConfig

PRESETS: dict[str, TrainConfig] = {
    # ResNet-18/CIFAR-10, cyclic code r=3 (s=1), reverse-gradient adversary
    "cyclic-resnet18": TrainConfig(
        network="ResNet18", dataset="Cifar10", approach="cyclic",
        num_workers=9, worker_fail=1, err_mode="rev_grad", batch_size=32,
        lr=0.01, momentum=0.9,
    ),
    # the geometric-median baseline under the same adversary schedule
    "geomedian-resnet18": TrainConfig(
        network="ResNet18", dataset="Cifar10", approach="baseline",
        mode="geometric_median", num_workers=9, worker_fail=1,
        err_mode="rev_grad", batch_size=32, lr=0.01, momentum=0.9,
    ),
}


def get_preset(name: str, **overrides) -> TrainConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r} (have {sorted(PRESETS)})")
    return dataclasses.replace(PRESETS[name], **overrides).validate()
