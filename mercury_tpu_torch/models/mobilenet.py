"""MobileNetV2, CIFAR variant, of ``mercury_tpu/models/mobilenet.py``:
inverted residual blocks with linear bottlenecks (Sandler et al. 2018),
width 32→1280, ReLU6. ``cifar_stem`` runs the stem and the first two
stride-2 stages at stride 1, so 32×32 inputs end on an 8×8 map."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mercury_tpu_torch.models.layers import BatchNorm, SameConv2d


class InvertedResidual(nn.Module):
    """Expand (1×1, absent at ``expand == 1``) → depthwise 3×3 → project
    (1×1), each followed by BatchNorm; ReLU6 after all but the projection.
    The input is added back when ``stride == 1`` and the widths match.
    ``convs``/``bns`` hold the layers in the Flax block's creation order."""

    def __init__(self, cin: int, filters: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        shapes = [] if expand == 1 else [(cin, hidden, 1, 1, 1)]
        shapes += [(hidden, hidden, 3, stride, hidden), (hidden, filters, 1, 1, 1)]
        self.convs = nn.ModuleList(SameConv2d(*s) for s in shapes)
        self.bns = nn.ModuleList(BatchNorm(s[1]) for s in shapes)
        self.residual = stride == 1 and cin == filters

    def forward(self, x, train: bool, keep_stats: bool):
        y, last = x, len(self.convs) - 1
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            y = bn(conv(y), train, keep_stats)
            if i < last:
                y = F.relu6(y)
        return y + x if self.residual else y


# (expansion t, channels c, repeats n, stride s): the V2 paper's Table 2.
_V2_CFG: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 10, width_mult: float = 1.0,
                 cifar_stem: bool = True, in_channels: int = 3):
        super().__init__()

        def c(ch):
            return max(8, int(ch * width_mult))

        self.stem_conv = SameConv2d(in_channels, c(32), 3, 1 if cifar_stem else 2)
        self.stem_bn = BatchNorm(c(32))
        blocks, cin, downs_reduced = [], c(32), 0
        for t, ch, n, s in _V2_CFG:
            for i in range(n):
                stride = s if i == 0 else 1
                if cifar_stem and stride == 2 and downs_reduced < 2:
                    stride = 1
                    downs_reduced += 1
                blocks.append(InvertedResidual(cin, c(ch), stride, t))
                cin = c(ch)
        self.blocks = nn.ModuleList(blocks)
        self.head_conv = SameConv2d(cin, c(1280), 1)
        self.head_bn = BatchNorm(c(1280))
        self.fc = nn.Linear(c(1280), num_classes)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None,
                keep_stats: bool = True) -> torch.Tensor:
        train = self.training if train is None else train
        x = F.relu6(self.stem_bn(self.stem_conv(x), train, keep_stats))
        for block in self.blocks:
            x = block(x, train, keep_stats)
        x = F.relu6(self.head_bn(self.head_conv(x), train, keep_stats))
        return self.fc(x.mean(dim=(2, 3))).float()
