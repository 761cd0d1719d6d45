"""Models of the port: the CIFAR-stem ResNets, the small debug CNN, the
VGGs, MobileNetV2, the BiLSTM-attention and Transformer sequence models and
ViT (both with the Switch mixture of experts as an option), under the JAX
package's names."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mercury_tpu_torch.models.layers import init_weights
from mercury_tpu_torch.models.lstm import AdditiveAttention, BiLSTMAttention
from mercury_tpu_torch.models.mobilenet import MobileNetV2
from mercury_tpu_torch.models.moe import MoEMLP
from mercury_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from mercury_tpu_torch.models.simple import SmallCNN
from mercury_tpu_torch.models.transformer import TransformerBlock, TransformerClassifier
from mercury_tpu_torch.models.vgg import CFG as VGG_CFG
from mercury_tpu_torch.models.vgg import VGG, make_vgg

_RESNETS = {"resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50,
            "resnet101": ResNet101, "resnet152": ResNet152}
_LSTMS = ("bilstm_attention", "mylstm", "lstm")
TRANSFORMERS = ("transformer", "vit")
MODELS = (*_RESNETS, "smallcnn", *VGG_CFG, "mobilenetv2", "mobilenet_v2", *_LSTMS,
          *TRANSFORMERS)


def require_transformer_for(option: str, name: str) -> None:
    """The JAX Trainer's refusal of ``option`` (``"remat"``,
    ``"moe_experts"``) outside the transformer family."""
    if name not in TRANSFORMERS:
        raise ValueError(f"{option} requires the transformer family "
                         f"(model='transformer'|'vit'), got {name!r}")


def create_model(name: str, num_classes: int = 10,
                 generator: Optional[torch.Generator] = None,
                 sample_shape: Tuple[int, int, int] = (32, 32, 3),
                 **kwargs) -> torch.nn.Module:
    """Build a model by name on the CPU with Flax-style initial weights
    drawn from ``generator`` (a CPU generator). ``sample_shape`` is one
    training sample's, ``(H, W, C)`` or ``(T, F)``: its last axis is the
    input's channels or features, and it sizes the VGG head as the Flax
    init on a sample does. ``kwargs`` go to the model (``width_mult``,
    ``cifar_stem``, ``hidden_dim``, ``d_model``, ...); ``vit`` defaults to
    ``patch_size=4``, ``num_layers=4`` and ``max_len=(32 // p)**2``, as the
    JAX package's. ``remat`` and ``moe_experts`` (None: the dense MLP) are
    for the transformer family only, as are ``sp_axis`` and ``sp_impl``
    (sequence parallelism, once ``parallel.sequence.bind_sequence_group``
    hands the model its group)."""
    key = name.lower()
    channels = sample_shape[-1]
    remat = kwargs.pop("remat", False)
    if remat:
        require_transformer_for("remat", key)
    moe_experts = kwargs.pop("moe_experts", None)
    if moe_experts is not None:
        require_transformer_for("moe_experts", key)
    if key in _RESNETS:
        model = _RESNETS[key](num_classes=num_classes, in_channels=channels, **kwargs)
    elif key in VGG_CFG:
        model = make_vgg(key, num_classes=num_classes, sample_shape=sample_shape, **kwargs)
    elif key in ("mobilenetv2", "mobilenet_v2"):
        model = MobileNetV2(num_classes=num_classes, in_channels=channels, **kwargs)
    elif key == "smallcnn":
        model = SmallCNN(num_classes=num_classes, in_channels=channels, **kwargs)
    elif key in _LSTMS:
        model = BiLSTMAttention(num_classes=num_classes, in_features=channels, **kwargs)
    elif key in TRANSFORMERS:
        if key == "vit":
            kwargs.setdefault("patch_size", 4)
            kwargs.setdefault("num_layers", 4)
            kwargs.setdefault("max_len", (32 // kwargs["patch_size"]) ** 2)
        model = TransformerClassifier(num_classes=num_classes, in_features=channels,
                                      remat=remat, moe_experts=moe_experts, **kwargs)
    else:
        raise ValueError(f"unknown model {name!r}; the port builds {sorted(MODELS)}")
    init_weights(model, generator)
    return model


__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "SmallCNN", "VGG", "VGG_CFG", "MobileNetV2", "MoEMLP", "AdditiveAttention",
           "BiLSTMAttention", "TransformerBlock", "TransformerClassifier", "MODELS",
           "TRANSFORMERS", "create_model", "make_vgg", "require_transformer_for"]
