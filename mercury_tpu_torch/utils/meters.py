"""Host-side metric meters — the PyTorch counterpart of
``mercury_tpu/utils/meters.py`` (the reference's ``Average``,
``EMAverage`` and ``Accuracy``).

They take Python numbers, numpy values or tensors (on any device) and
``float()`` them on the host: a tensor on the card is read back, so a
meter belongs off the step's hot path. The EMA the importance sampler
carries lives on the device in :mod:`mercury_tpu_torch.sampling.importance`.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """``x`` as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Average:
    """Running weighted mean."""

    def __init__(self) -> None:
        self.sum = 0.0
        self.count = 0

    def update(self, value, number: int = 1) -> None:
        self.sum += float(value) * number
        self.count += number

    @property
    def average(self) -> float:
        if self.count == 0:
            return 0.0
        return self.sum / self.count

    def reset(self) -> None:
        self.sum = 0.0
        self.count = 0

    def __str__(self) -> str:
        return f"{self.average:.6f}"


class EMAverage:
    """Exponential moving average with a first-update bootstrap: the first
    ``update`` sets the EMA to the raw value; later updates blend
    ``alpha·ema + (1 − alpha)·value``."""

    def __init__(self, alpha: float = 0.9) -> None:
        self.alpha = alpha
        self.value = 0.0
        self.count = 0

    def update(self, value, number: int = 1) -> None:
        value = float(value)
        if self.count == 0:
            self.value = value
        else:
            self.value = self.alpha * self.value + (1.0 - self.alpha) * value
        self.count += number

    @property
    def average(self) -> float:
        return self.value

    def reset(self) -> None:
        self.value = 0.0
        self.count = 0

    def __str__(self) -> str:
        return f"{self.average:.6f}"


class Accuracy:
    """Argmax accuracy meter."""

    def __init__(self) -> None:
        self.correct = 0
        self.count = 0

    def update(self, logits, targets) -> None:
        logits = _host(logits)
        targets = _host(targets)
        preds = logits.argmax(axis=-1)
        self.correct += int((preds == targets).sum())
        self.count += int(targets.shape[0])

    def update_counts(self, correct, count) -> None:
        """Accumulate counts already reduced (e.g. summed over the ranks)."""
        self.correct += int(correct)
        self.count += int(count)

    @property
    def accuracy(self) -> float:
        if self.count == 0:
            return 0.0
        return self.correct / self.count

    def reset(self) -> None:
        self.correct = 0
        self.count = 0

    def __str__(self) -> str:
        return f"{self.accuracy * 100:.2f}%"
