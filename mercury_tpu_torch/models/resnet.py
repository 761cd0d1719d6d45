"""CIFAR-stem ResNet family in PyTorch, numerically matched to the Flax
models of ``mercury_tpu/models/resnet.py`` so weights carry across
(``models/convert.py``) and the two forwards agree.

Two details of the Flax layers that plain ``nn.Conv2d``/``nn.BatchNorm2d``
get wrong:

- **SAME padding.** Flax convolutions pad "SAME": XLA puts the odd pixel of
  a stride-2 3×3 conv on the high side, ``(0, 1)``, where ``padding=1``
  pads ``(1, 1)`` and shifts every later stage by a pixel.
  :class:`SameConv2d` pads as XLA does.
- **BatchNorm statistics.** Flax keeps ``ra ← 0.9·ra + 0.1·batch`` with the
  *biased* batch variance; ``F.batch_norm(training=True)`` updates
  ``running_var`` with the unbiased one. :class:`BatchNorm` normalizes with
  ``F.batch_norm`` and updates its running statistics itself. It also
  takes ``keep_stats=False``: normalize with batch statistics and leave the
  running ones untouched, as the candidate-scoring forward must.
- **Synced statistics.** With ``sync`` set and more than one rank, the
  batch statistics are the ranks' mean, as Flax's ``BatchNorm(axis_name=
  ...)`` computes them (:meth:`BatchNorm.synced`).

The forward takes NCHW (or its channels_last view) and returns float32
logits; on the card the step runs it under bf16 autocast.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from mercury_tpu_torch.parallel.collectives import all_reduce_mean


def _same_pads(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Bias-free conv with XLA's "SAME" padding: ``total = max((ceil(n/s)
    − 1)·s + k − n, 0)``, the low side getting ``total // 2``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        top, bottom = _same_pads(x.shape[-2], kh, sh)
        left, right = _same_pads(x.shape[-1], kw, sw)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, None, self.stride, (top, left))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, None, self.stride, 0)


class BatchNorm(nn.Module):
    """Flax-semantics batch norm over NCHW channels (momentum 0.9 on the
    running average, biased variance, eps 1e-5). ``sync`` (the Flax
    model's ``bn_axis_name``) averages the batch statistics over the ranks;
    whoever builds the model sets it only at more than one rank
    (:func:`set_sync_batch_norm`), so one rank keeps ``F.batch_norm``."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, sync: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.sync = sync
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool,
                keep_stats: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.sync:
            return self.synced(x, keep_stats)
        if keep_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
                self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    def synced(self, x: torch.Tensor, keep_stats: bool) -> torch.Tensor:
        """Train-mode batch norm with the ranks' mean statistics: Flax
        0.12's ``_compute_stats`` with ``use_fast_variance`` and float32
        reductions. Each rank's float32 ``E[x]`` and ``E[x²]`` over (N, H,
        W) are averaged by one all-reduce of the stacked ``[2, C]`` tensor
        (whose backward all-reduces the gradient, as ``pmean``'s transpose
        does), ``var = max(E[x²] − E[x]², 0)``, and the output is cast to
        the input's dtype."""
        xf = x.float()
        local = torch.stack([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
        mean, mean_sq = all_reduce_mean(local)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        if keep_stats:
            self._update_running(mean.detach(), var.detach())
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        self.running_var.mul_(m).add_(var, alpha=1.0 - m)


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


def set_sync_batch_norm(model: nn.Module, sync: bool) -> nn.Module:
    """Set ``sync`` on every :class:`BatchNorm` of ``model``: the Flax
    model's ``bn_axis_name``, which the trainer sets for
    ``batch_norm="sync"`` at more than one rank."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.sync = sync
    return model


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's defaults: LeCun-normal kernels (truncated at 2σ), zero
    biases; BN scale 1, bias 0."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            # 0.8796 is the std of a unit normal truncated at ±2.
            std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if getattr(mod, "bias", None) is not None:
                nn.init.zeros_(mod.bias)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=Bottleneck)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=Bottleneck)
