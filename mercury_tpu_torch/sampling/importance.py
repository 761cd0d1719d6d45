"""The Mercury importance-sampling core as plain tensor functions — the
PyTorch counterpart of ``mercury_tpu/sampling/importance.py``.

Score every candidate of a pool by its per-sample loss, keep an EMA of the
mean pool loss (the first update bootstraps it), smooth ``score = loss +
α·EMA``, normalize to ``p``, draw the batch with replacement, and reweight
the training loss by ``1/(N·p)`` so it stays an unbiased estimate of the
uniform-sampling loss.

The draw is an inverse-CDF draw from given uniforms — ``idx_b = #{j :
cdf_j ≤ u_b}``, clamped to ``N − 1`` — the rule of the fused score-and-draw
kernel, so one set of uniforms gives the same batch in both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mercury_tpu_torch.parallel.collectives import psum_stats, world

# Floor of the smoothed scores before normalization (the all-zero pool).
SCORE_FLOOR = 1e-12


class EMAState(NamedTuple):
    """EMA of the mean pool loss, on the device."""

    value: torch.Tensor  # [] float32
    count: torch.Tensor  # [] int32 — updates so far (0 → bootstrap next)


def init_ema(device=None) -> EMAState:
    return EMAState(value=torch.zeros((), dtype=torch.float32, device=device),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def ema_update(state: EMAState, value: torch.Tensor,
               alpha: float = 0.9) -> EMAState:
    """``ema ← α·ema + (1−α)·value``; the first update takes ``value``."""
    value = value.to(torch.float32)
    new = torch.where(state.count == 0, value,
                      alpha * state.value + (1.0 - alpha) * value)
    return EMAState(value=new, count=state.count + 1)


def per_sample_loss(logits: torch.Tensor, labels: torch.Tensor,
                    label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-sample cross-entropy (``reduction='none'``) in float32."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    if label_smoothing > 0.0:
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def per_sample_grad_norm_bound(logits: torch.Tensor, labels: torch.Tensor,
                               label_smoothing: float = 0.0) -> torch.Tensor:
    """``‖softmax(z_i) − target(y_i)‖₂`` in float32, the exact norm of the
    cross-entropy gradient with respect to the logits, with the target
    ``(1−ls)·onehot + ls/C``: the Katharopoulos-Fleuret importance score
    (arXiv:1803.00942) and the grad-variance probe's ``g_i``. A label
    outside ``[0, C)`` has an all-zero one-hot row, as ``jax.nn.one_hot``
    gives; the one-hot is a compare, which reads nothing back to the
    host."""
    logits = logits.to(torch.float32)
    k = logits.shape[-1]
    p = torch.softmax(logits, dim=-1)
    classes = torch.arange(k, device=logits.device)
    target = (labels.long()[:, None] == classes).to(torch.float32)
    if label_smoothing > 0.0:
        target = (1.0 - label_smoothing) * target + label_smoothing / k
    return torch.linalg.vector_norm(p - target, dim=-1)


def smoothed_scores(losses: torch.Tensor, ema_value,
                    alpha: float = 0.5) -> torch.Tensor:
    """``score_i = loss_i + α·EMA`` before the floor and normalization."""
    return losses.to(torch.float32) + alpha * ema_value


def importance_probs(losses: torch.Tensor, ema_value,
                     alpha: float = 0.5) -> torch.Tensor:
    """Smoothed, floored scores normalized to a distribution."""
    scores = torch.clamp(smoothed_scores(losses, ema_value, alpha),
                         min=SCORE_FLOOR)
    return scores / scores.sum()


def draw_with_replacement(probs: torch.Tensor,
                          uniforms: torch.Tensor) -> torch.Tensor:
    """One draw per uniform by inverse CDF: ``#{j : cdf_j ≤ u}`` (an upper
    bound in the cumulative sum), clamped to the last index."""
    cdf = torch.cumsum(probs, dim=0)
    idx = torch.searchsorted(cdf, uniforms.reshape(-1).contiguous(),
                             right=True)
    return idx.clamp_(max=probs.shape[0] - 1)


def reweighted_loss(losses: torch.Tensor,
                    scaled_probs: torch.Tensor) -> torch.Tensor:
    """Unbiased estimator ``mean(loss_i / (N·p_i))``."""
    return (losses / scaled_probs).mean()


def pool_mean(pool_losses: torch.Tensor, sync: bool = False, group=None) -> torch.Tensor:
    """Mean pool loss. With ``sync`` and more than one rank in ``group``
    (None: the default group), the **global** mean: the sum and the count
    all-reduced over the ranks (``psum(sum)/psum(count)``), so every rank's
    EMA stays the same. At one rank the global mean is the local one."""
    pool_losses = pool_losses.to(torch.float32)
    if sync and world(group) > 1:
        total, count = psum_stats(pool_losses.sum(),
                                  pool_losses.new_full((), pool_losses.shape[0]), group)
        return total / count
    return pool_losses.mean()


class SelectionResult(NamedTuple):
    ema: EMAState
    selected: torch.Tensor       # [B] int64 — positions in the pool
    scaled_probs: torch.Tensor   # [B] float32 — p_i·N of the drawn samples
    avg_pool_loss: torch.Tensor  # [] float32


def select_from_pool(pool_losses: torch.Tensor, ema: EMAState,
                     uniforms: torch.Tensor, is_alpha: float = 0.5,
                     ema_alpha: float = 0.9) -> SelectionResult:
    """EMA update, then score → normalize → draw, then ``p·N`` of each
    drawn candidate."""
    pool_losses = pool_losses.to(torch.float32)
    n = pool_losses.shape[0]
    mean_loss = pool_mean(pool_losses)
    new_ema = ema_update(ema, mean_loss, ema_alpha)
    probs = importance_probs(pool_losses, new_ema.value, is_alpha)
    selected = draw_with_replacement(probs, uniforms)
    return SelectionResult(ema=new_ema, selected=selected,
                           scaled_probs=probs[selected] * n,
                           avg_pool_loss=mean_loss)


def uniform_selection(pool_size: int, batch_size: int,
                      generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform control arm: uniform draws with unit weights."""
    selected = torch.randint(0, pool_size, (batch_size,), generator=generator,
                             device=generator.device)
    return selected, torch.ones(batch_size, dtype=torch.float32,
                                device=generator.device)
