"""The small debug CNN of ``mercury_tpu/models/simple.py``: two stride-2
SAME 3×3 convs with BatchNorm and ReLU, a spatial mean and a linear head,
for tests and quick runs where a ResNet is more than they need."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mercury_tpu_torch.models.layers import BatchNorm, SameConv2d


class SmallCNN(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 16, in_channels: int = 3):
        super().__init__()
        widths = (in_channels, width, width * 2)
        self.convs = nn.ModuleList(SameConv2d(a, b, 3, 2)
                                   for a, b in zip(widths, widths[1:]))
        self.bns = nn.ModuleList(BatchNorm(b) for b in widths[1:])
        self.fcs = nn.ModuleList([nn.Linear(widths[-1], num_classes)])

    def forward(self, x: torch.Tensor, train: Optional[bool] = None,
                keep_stats: bool = True) -> torch.Tensor:
        train = self.training if train is None else train
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x), train, keep_stats))
        return self.fcs[0](x.mean(dim=(2, 3))).float()
