"""Model zoo of the port — the CIFAR ResNet family (draco_tpu/models)."""

from draco_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)

_REGISTRY = {
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
}


def input_shape(dataset: str):
    """Per-dataset sample shape, NHWC."""
    d = dataset.lower()
    if "mnist" in d:
        return (28, 28, 1)
    if "cifar" in d:
        return (32, 32, 3)
    raise ValueError(f"unknown dataset: {dataset}")


def build_model(name: str, dataset: str, num_classes: int = 10) -> ResNet:
    """Name-based construction; the input channels follow the dataset."""
    if name not in _REGISTRY:
        raise ValueError(f"network {name!r} is not ported (have "
                         f"{sorted(_REGISTRY)})")
    return _REGISTRY[name](num_classes=num_classes,
                           in_channels=input_shape(dataset)[-1])
