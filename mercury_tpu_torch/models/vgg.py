"""The VGG family of ``mercury_tpu/models/vgg.py``: conv3×3 (padding 1) +
BatchNorm + ReLU stages with 2×2/2 max-pools, by the ``CFG`` depth
tables, then a head of fc(·→hidden_dim), ReLU, fc(hidden_dim→classes).

The features are flattened channels-last, ``[N, H·W·C]``, as Flax flattens
its NHWC map, so the Dense weights carried across from Flax line up at any
image size (at 32×32 the last map is 1×1 and the order does not matter).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from mercury_tpu_torch.models.layers import BatchNorm

# Conv widths, "M" a 2×2 max-pool.
CFG = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
              "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    """``sample_shape`` ``(H, W, C)`` of one image gives the input channels
    and the head's input width, as the Flax model's init on a sample
    does."""

    def __init__(self, cfg: Sequence[Union[int, str]], num_classes: int = 10,
                 hidden_dim: int = 128, sample_shape: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        self.cfg = list(cfg)
        h, w, cin = sample_shape
        convs, bns = [], []
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
            else:
                convs.append(nn.Conv2d(cin, int(v), 3, padding=1, bias=False))
                bns.append(BatchNorm(int(v)))
                cin = int(v)
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.fcs = nn.ModuleList([nn.Linear(h * w * cin, hidden_dim),
                                  nn.Linear(hidden_dim, num_classes)])

    def forward(self, x: torch.Tensor, train: Optional[bool] = None,
                keep_stats: bool = True) -> torch.Tensor:
        train = self.training if train is None else train
        layers = iter(zip(self.convs, self.bns))
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                conv, bn = next(layers)
                x = F.relu(bn(conv(x), train, keep_stats))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fcs[1](F.relu(self.fcs[0](x))).float()


def make_vgg(name: str, **kwargs) -> VGG:
    """A VGG by name: "vgg11", "vgg13", "vgg16" or "vgg19"."""
    return VGG(CFG[name.lower()], **kwargs)
