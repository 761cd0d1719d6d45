"""CIFAR-stem ResNet family in PyTorch, numerically matched to the Flax
models of ``mercury_tpu/models/resnet.py`` so weights carry across
(``models/convert.py``) and the two forwards agree. Its layers
(:class:`SameConv2d`, :class:`BatchNorm`) are in ``models/layers.py`` and
exported here too.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from mercury_tpu_torch.models.layers import (  # noqa: F401
    BatchNorm,
    SameConv2d,
    init_weights,
    set_sync_batch_norm,
)


class BasicBlock(nn.Module):
    """3×3-3×3 residual block, 1×1-conv shortcut on a stride or width
    change."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.conv1 = SameConv2d(cin, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = SameConv2d(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.down_conv = self.down_bn = None
        if stride != 1 or cin != filters:
            self.down_conv = SameConv2d(cin, filters, 1, stride)
            self.down_bn = BatchNorm(filters)

    def forward(self, x, train: bool, keep_stats: bool):
        y = F.relu(self.bn1(self.conv1(x), train, keep_stats))
        y = self.bn2(self.conv2(y), train, keep_stats)
        if self.down_conv is not None:
            x = self.down_bn(self.down_conv(x), train, keep_stats)
        return F.relu(x + y)


class Bottleneck(nn.Module):
    """1×1-3×3-1×1 bottleneck, expansion 4."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = SameConv2d(cin, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = SameConv2d(filters, filters, 3, stride)
        self.bn2 = BatchNorm(filters)
        self.conv3 = SameConv2d(filters, out, 1)
        self.bn3 = BatchNorm(out)
        self.down_conv = self.down_bn = None
        if stride != 1 or cin != out:
            self.down_conv = SameConv2d(cin, out, 1, stride)
            self.down_bn = BatchNorm(out)

    def forward(self, x, train: bool, keep_stats: bool):
        y = F.relu(self.bn1(self.conv1(x), train, keep_stats))
        y = F.relu(self.bn2(self.conv2(y), train, keep_stats))
        y = self.bn3(self.conv3(y), train, keep_stats)
        if self.down_conv is not None:
            x = self.down_bn(self.down_conv(x), train, keep_stats)
        return F.relu(x + y)


class ResNet(nn.Module):
    """CIFAR-stem ResNet: 3×3 stem conv + BN, stages at strides 1/2/2/…,
    global average pool, linear head."""

    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: Type[nn.Module], num_classes: int = 10,
                 num_filters: int = 64, in_channels: int = 3):
        super().__init__()
        self.conv = SameConv2d(in_channels, num_filters, 3)
        self.bn = BatchNorm(num_filters)
        blocks, cin = [], num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(block_cls(cin, filters, stride))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None,
                keep_stats: bool = True) -> torch.Tensor:
        """``train`` (default ``self.training``) normalizes with batch
        statistics; ``keep_stats=False`` then leaves the running statistics
        as they were."""
        train = self.training if train is None else train
        x = F.relu(self.bn(self.conv(x), train, keep_stats))
        for block in self.blocks:
            x = block(x, train, keep_stats)
        return self.fc(x.mean(dim=(2, 3))).float()


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=Bottleneck)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=Bottleneck)
