"""Layers shared by the port's image models, and every model's Flax-style
initializer, numerically matched to the Flax layers of
``mercury_tpu/models`` so weights carry across (``models/convert.py``) and
the forwards agree.

Two details of the Flax layers that plain ``nn.Conv2d``/``nn.BatchNorm2d``
get wrong:

- **SAME padding.** Flax convolutions pad "SAME": XLA puts the odd pixel of
  a stride-2 3×3 conv on the high side, ``(0, 1)``, where ``padding=1``
  pads ``(1, 1)`` and shifts every later stage by a pixel.
  :class:`SameConv2d` pads as XLA does, depthwise (``groups``) too.
- **BatchNorm statistics.** Flax keeps ``ra ← 0.9·ra + 0.1·batch`` with the
  *biased* batch variance; ``F.batch_norm(training=True)`` updates
  ``running_var`` with the unbiased one. :class:`BatchNorm` normalizes with
  ``F.batch_norm`` and updates its running statistics itself. It also
  takes ``keep_stats=False``: normalize with batch statistics and leave the
  running ones untouched, as the candidate-scoring forward must.
- **Synced statistics.** With ``sync`` set and more than one rank, the
  batch statistics are the ranks' mean, as Flax's ``BatchNorm(axis_name=
  ...)`` computes them (:meth:`BatchNorm.synced`).

Every model takes NCHW (or its channels_last view), has ``forward(x,
train=None, keep_stats=True)`` and returns float32 logits; on the card the
step runs it under bf16 autocast.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mercury_tpu_torch.parallel.collectives import all_reduce_mean, rank, world
from mercury_tpu_torch.parallel.mesh import GroupRef


def _same_pads(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Bias-free conv with XLA's "SAME" padding: ``total = max((ceil(n/s)
    − 1)·s + k − n, 0)``, the low side getting ``total // 2``. ``groups``
    is Flax's ``feature_group_count`` (``groups == cin``: depthwise)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=False,
                         groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        top, bottom = _same_pads(x.shape[-2], kh, sh)
        left, right = _same_pads(x.shape[-1], kw, sw)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, None, self.stride, (top, left), 1,
                            self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, None, self.stride, 0, 1, self.groups)


class BatchNorm(nn.Module):
    """Flax-semantics batch norm over NCHW channels (momentum 0.9 on the
    running average, biased variance, eps 1e-5). ``sync`` (the Flax
    model's ``bn_axis_name``) averages the batch statistics over the ranks;
    whoever builds the model sets it only at more than one rank
    (:func:`set_sync_batch_norm`), so one rank keeps ``F.batch_norm``;
    ``sync_group`` holds the group it averages over (None: the default
    group)."""

    sync_group = None

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
        group = None if self.sync_group is None else self.sync_group.group
        mean, mean_sq = all_reduce_mean(local, group)
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


def set_sync_batch_norm(model: nn.Module, sync: bool, group=None) -> nn.Module:
    """Set ``sync`` on every :class:`BatchNorm` of ``model``: the Flax
    model's ``bn_axis_name``, which the trainer sets for
    ``batch_norm="sync"`` at more than one rank. ``group`` is the process
    group the statistics are averaged over (None: the default group; the
    data group under a second mesh axis)."""
    ref = None if group is None else GroupRef(group, world(group), rank(group))
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.sync = sync
            mod.sync_group = ref
    return model


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's defaults: LeCun-normal kernels (truncated at 2σ), zero
    biases; BN and LayerNorm scale 1, bias 0. Then a module's own
    ``flax_init(generator)``, where it has one, for Flax's other
    initializers (the LSTM's orthogonal hidden kernels, the Transformer's
    ``normal(0.02)`` positional embedding)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            # 0.8796 is the std of a unit normal truncated at ±2.
            std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if getattr(mod, "bias", None) is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    for mod in model.modules():
        if hasattr(mod, "flax_init"):
            mod.flax_init(generator)
