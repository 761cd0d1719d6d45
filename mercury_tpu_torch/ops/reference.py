"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes what its CUDA kernel in ``csrc/mercury_kernels.cu``
computes, with the same arithmetic in float32. The wrappers in
``ops/mercury_kernels.py`` use them for tensors on the CPU (the tests), and
``chip_smoke.py`` holds each kernel against them on the card. Nothing on
the main path calls them when the tensors are on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mercury_tpu_torch.sampling.importance import (
    draw_with_replacement,
    importance_probs,
)


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
