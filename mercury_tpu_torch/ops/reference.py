"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes what its CUDA kernel in ``csrc/mercury_kernels.cu``
computes, with the same arithmetic in float32. The wrappers in
``ops/mercury_kernels.py`` use them for tensors on the CPU (the tests), and
``chip_smoke.py`` holds each kernel against them on the card. Nothing on
the main path calls them when the tensors are on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mercury_tpu_torch.data.pipeline import augment_batch
from mercury_tpu_torch.sampling.importance import (
    draw_with_replacement,
    importance_probs,
)
from mercury_tpu_torch.sampling.scoretable import (
    decay_scores,
    scatter_mean,
    table_probs,
)

# 1/255 rounded once to float32, as a Python float (exact in float64).
INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _onehot(labels: torch.Tensor, c: int, device) -> torch.Tensor:
    # A comparison, not F.one_hot: a label outside [0, C) picks no column,
    # as in the kernels, instead of raising.
    return torch.arange(c, device=device)[None, :] == labels.long()[:, None]


def nll_forward(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``nll_i = logsumexp(z_i) − z_i[y_i]`` in float32, ``[N]``."""
    z = logits.to(torch.float32)
    m = z.max(dim=1, keepdim=True).values
    lse = torch.log(torch.exp(z - m).sum(dim=1)) + m[:, 0]
    picked = torch.where(_onehot(labels, z.shape[1], z.device), z, 0.0).sum(dim=1)
    return lse - picked


def nll_backward(logits: torch.Tensor, labels: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """``(softmax(z_i) − onehot(y_i))·g_i``, cast to the logits' dtype."""
    z = logits.to(torch.float32)
    e = torch.exp(z - z.max(dim=1, keepdim=True).values)
    softmax = e / e.sum(dim=1, keepdim=True)
    onehot = _onehot(labels, z.shape[1], z.device).to(torch.float32)
    grad = (softmax - onehot) * g.to(torch.float32).reshape(-1, 1)
    return grad.to(logits.dtype)


def score_and_draw(losses: torch.Tensor, ema_value, uniforms: torch.Tensor,
                   alpha: float = 0.5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``p = max(loss + α·ema, 1e-12) / Σ``, then ``idx_b = min(#{j :
    cdf_j ≤ u_b}, N−1)`` and ``scaled_b = p[idx_b]·N``. Returns ``(probs
    [N] float32, selected [B] int32, scaled [B] float32)``."""
    n = losses.shape[0]
    probs = importance_probs(losses, ema_value, alpha)
    selected = draw_with_replacement(probs, uniforms)
    return probs, selected.to(torch.int32), probs[selected] * n


def table_refresh_draw(scores: torch.Tensor, slots: torch.Tensor,
                       rscores: torch.Tensor, ema_value, uniforms: torch.Tensor,
                       alpha: float = 0.5, decay: float = 0.98
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decay the table toward the EMA (``μ + (t − μ)·γ``), scatter-mean the
    ``R`` refresh scores in at ``slots``, then ``p = max(t + α·μ, 1e-12) /
    Σ``, ``idx_b = min(#{j : cdf_j ≤ u_b}, L−1)`` and ``scaled_b =
    p[idx_b]·L``. Returns ``(new_table [L], probs [L], selected [B]
    int32, scaled [B])``."""
    n = scores.shape[0]
    decayed = decay_scores(scores.to(torch.float32), ema_value, decay)
    refreshed = scatter_mean(decayed, slots, rscores)
    probs = table_probs(refreshed, ema_value, alpha)
    selected = draw_with_replacement(probs, uniforms)
    return refreshed, probs, selected.to(torch.int32), probs[selected] * n


def dequant_normalize(raw: torch.Tensor, mean: torch.Tensor,
                      std: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 ``fma(x, RN(1/255), −mean) / std``: the arithmetic
    of the TPU ingest kernel as XLA compiles it (the division by the
    constant 255 becomes a multiply by its rounded reciprocal, contracted
    with the mean's subtraction into one fused multiply-add; the division
    by ``std`` stays a division). ``x·RN(1/255) − mean`` is exact in
    float64 for 8-bit ``x``, so one cast to float32 is the fma's single
    rounding. It can differ from ``normalize_images`` (``x/255``, then
    ``− mean``) in the last bit."""
    t = (raw.to(torch.float64) * INV_255 - mean.to(torch.float64)).to(torch.float32)
    return t / std.to(torch.float32)


def augment_normalize(raw: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                      crop: torch.Tensor, flip: torch.Tensor, pad: int = 4,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fused ingest: :func:`dequant_normalize`, then ``augment_batch``
    (zero-pad by ``pad`` after normalizing, so out-of-bounds pixels are
    +0.0; crop at ``crop [N, 2]``; flip where ``flip [N]``), then the cast
    to ``out_dtype`` as the last op. ``[N, H, W, C]`` NHWC in and out."""
    x = dequant_normalize(raw, mean, std)
    return augment_batch(x, crop, flip, pad).to(out_dtype)
