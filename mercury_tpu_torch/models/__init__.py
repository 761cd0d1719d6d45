"""Models of the port: the CIFAR-stem ResNets."""

from __future__ import annotations

from typing import Optional

import torch

from mercury_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
    init_weights,
)

_RESNETS = {"resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50,
            "resnet101": ResNet101, "resnet152": ResNet152}


def create_model(name: str, num_classes: int = 10,
                 generator: Optional[torch.Generator] = None) -> ResNet:
    """Build a ResNet by name on the CPU with Flax-style initial weights
    drawn from ``generator`` (a CPU generator)."""
    key = name.lower()
    if key not in _RESNETS:
        raise ValueError(
            f"unknown model {name!r}; the port builds {sorted(_RESNETS)}")
    model = _RESNETS[key](num_classes=num_classes)
    init_weights(model, generator)
    return model


__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "create_model"]
