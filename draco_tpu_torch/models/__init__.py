"""Model zoo of the port (draco_tpu/models): LeNet, FC, the CIFAR ResNet
family and the VGG family, each with the reference's compute dtype."""

import torch

from draco_tpu_torch.models.fc import FC_NN
from draco_tpu_torch.models.lenet import LeNet
from draco_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from draco_tpu_torch.models.vgg import (
    VGG,
    VGG11,
    VGG11_bn,
    VGG13,
    VGG13_bn,
    VGG16,
    VGG16_bn,
    VGG19,
    VGG19_bn,
)

_RESNETS = {
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
}
_VGGS = {
    "VGG11": VGG11,
    "VGG11_bn": VGG11_bn,
    "VGG13": VGG13,
    "VGG13_bn": VGG13_bn,
    "VGG16": VGG16,
    "VGG16_bn": VGG16_bn,
    "VGG19": VGG19,
    "VGG19_bn": VGG19_bn,
}
NAMES = ("LeNet", "FC") + tuple(_RESNETS) + tuple(_VGGS)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def input_shape(dataset: str):
    """Per-dataset sample shape, NHWC."""
    d = dataset.lower()
    if "mnist" in d:
        return (28, 28, 1)
    if "cifar" in d:
        return (32, 32, 3)
    raise ValueError(f"unknown dataset: {dataset}")


def dropout_features(name: str) -> tuple:
    """The widths of a network's dropout layers, whose keep-masks a
    training step draws (() for a network without dropout)."""
    return VGG.dropout_features if name in _VGGS else ()


def build_model(name: str, dataset: str, num_classes: int = 10,
                dtype=None):
    """Name-based construction; the input shape follows the dataset.
    ``dtype``: the compute dtype of the convolutions and Dense layers
    ("float32" | "bfloat16" or a torch dtype; None computes in the
    weights' dtype); parameters, BN statistics and logits stay float32."""
    if isinstance(dtype, str):
        dtype = COMPUTE_DTYPES[dtype]
    h, w, c = input_shape(dataset)
    if name == "LeNet":
        return LeNet(num_classes, c, h, dtype)
    if name == "FC":
        return FC_NN(num_classes, h * w * c, dtype)
    if name in _RESNETS:
        return _RESNETS[name](num_classes, c, dtype)
    if name in _VGGS:
        return _VGGS[name](num_classes, c, dtype)
    raise ValueError(f"network {name!r} is not ported (have {list(NAMES)})")
