"""Sampler-health scalars of the step, as plain functions on tensors: the
PyTorch counterpart of ``mercury_tpu/obs/diagnostics.py``.

- :func:`ess_fraction`: the normalized effective sample size of the
  importance weights (1 for uniform weights, ``1/B`` when one sample
  carries the batch), the signal Katharopoulos & Fleuret
  (arXiv:1803.00942) build their IS-on/off switch from;
- :func:`clip_fraction`: the share of candidates whose smoothed score sits
  at the normalization's floor (the draw has silently become uniform);
- :func:`ema_drift`: the fresh score mean minus the pre-update EMA;
- :func:`table_ages` and :func:`table_age_summary`: the score table's
  staleness in refresh sweeps, from the round-robin cursor;
- :func:`global_grad_norm`: the L2 norm of the (all-reduced) gradient.

Each runs on the device of its input and reads nothing back to the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from mercury_tpu_torch.sampling.importance import SCORE_FLOOR, smoothed_scores


def ess_fraction(scaled_probs: torch.Tensor) -> torch.Tensor:
    """``(Σw)² / (B·Σw² + 1e-30)`` with ``w_i = 1/(N·p_i)``, the reweight
    the loss applies: a float32 scalar in ``(0, 1]``, exactly 1.0 for unit
    weights. The ratio is taken in float64 from the float32 weights and
    rounded once: in float32 a batch of weights equal to within an ulp
    (a nearly flat score table) gives 1 + 2⁻²³."""
    w = (1.0 / scaled_probs.to(torch.float32)).double()
    b = scaled_probs.shape[0]
    return (w.sum().square() / (b * w.square().sum() + 1e-30)).to(torch.float32)


def clip_fraction(scores: torch.Tensor, ema_value, alpha: float = 0.5) -> torch.Tensor:
    """Share of candidates whose smoothed score ``loss + α·EMA`` is at or
    below the ``importance_probs`` floor: a float32 scalar in ``[0, 1]``."""
    s = smoothed_scores(scores, ema_value, alpha)
    return (s <= SCORE_FLOOR).to(torch.float32).mean()


def ema_drift(fresh_mean: torch.Tensor, ema_prev: torch.Tensor) -> torch.Tensor:
    """Signed drift of the fresh score mean from the pre-update EMA."""
    return fresh_mean.to(torch.float32) - ema_prev.to(torch.float32)


def table_ages(cursor: int, n_slots: int, refresh_size: int, device=None) -> torch.Tensor:
    """Per-slot age ``[L]`` (float32, in refresh sweeps) behind the newest
    refreshed slot ``cursor + R − 1``: the slots of this step's window age
    0, the window refreshed one step ago 1, and so on."""
    newest = cursor + refresh_size - 1
    behind = torch.remainder(newest - torch.arange(n_slots, device=device), n_slots)
    return torch.div(behind, refresh_size, rounding_mode="floor").to(torch.float32)


def table_age_summary(n_slots: int, refresh_size: int) -> Tuple[float, float, float]:
    """(min, mean, max) of :func:`table_ages`, on the host with no launch:
    the ages are a rotation of ``b // R`` for ``b`` in ``[0, L)``, so they
    do not depend on the cursor. min is 0 and max ``(L − 1) // R``; the mean
    is their sum (exact) times the float32 reciprocal of ``L``, which is how
    the JAX package's float32 ``jnp.mean`` of the ages rounds it on the CPU
    while the sum stays below 2²⁴."""
    full, rem = divmod(n_slots, refresh_size)
    total = refresh_size * full * (full - 1) // 2 + rem * full
    mean = np.float32(total) * (np.float32(1.0) / np.float32(n_slots))
    return 0.0, float(mean), float((n_slots - 1) // refresh_size)


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm of a list of gradients, a float32 scalar: one
    ``_foreach_norm`` over the list and one norm of the stacked norms."""
    norms = torch._foreach_norm(list(grads))
    return torch.linalg.vector_norm(torch.stack(norms).to(torch.float32))
