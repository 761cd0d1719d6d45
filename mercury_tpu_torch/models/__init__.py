"""Models of the port: the CIFAR-stem ResNets, the small debug CNN, the
VGGs and MobileNetV2, under the JAX package's names."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mercury_tpu_torch.models.layers import init_weights
from mercury_tpu_torch.models.mobilenet import MobileNetV2
from mercury_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from mercury_tpu_torch.models.simple import SmallCNN
from mercury_tpu_torch.models.vgg import CFG as VGG_CFG
from mercury_tpu_torch.models.vgg import VGG, make_vgg

_RESNETS = {"resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50,
            "resnet101": ResNet101, "resnet152": ResNet152}
MODELS = (*_RESNETS, "smallcnn", *VGG_CFG, "mobilenetv2", "mobilenet_v2")


def create_model(name: str, num_classes: int = 10,
                 generator: Optional[torch.Generator] = None,
                 sample_shape: Tuple[int, int, int] = (32, 32, 3),
                 **kwargs) -> torch.nn.Module:
    """Build a model by name on the CPU with Flax-style initial weights
    drawn from ``generator`` (a CPU generator). ``sample_shape`` ``(H, W,
    C)`` is one training image's: its channels are the input's, and it
    sizes the VGG head as the Flax init on a sample does. ``kwargs`` go to
    the model (``width_mult``, ``cifar_stem``, ``hidden_dim``, ...)."""
    key = name.lower()
    channels = sample_shape[-1]
    if key in _RESNETS:
        model = _RESNETS[key](num_classes=num_classes, in_channels=channels, **kwargs)
    elif key in VGG_CFG:
        model = make_vgg(key, num_classes=num_classes, sample_shape=sample_shape, **kwargs)
    elif key in ("mobilenetv2", "mobilenet_v2"):
        model = MobileNetV2(num_classes=num_classes, in_channels=channels, **kwargs)
    elif key == "smallcnn":
        model = SmallCNN(num_classes=num_classes, in_channels=channels, **kwargs)
    else:
        raise ValueError(f"unknown model {name!r}; the port builds {sorted(MODELS)}")
    init_weights(model, generator)
    return model


__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "SmallCNN", "VGG", "VGG_CFG", "MobileNetV2", "MODELS", "create_model",
           "make_vgg"]
