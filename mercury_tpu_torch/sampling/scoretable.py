"""Persistent per-shard score table with a round-robin refresh — the
PyTorch counterpart of ``mercury_tpu/sampling/scoretable.py``.

The ``sampler="scoretable"`` step keeps a ``[L]`` float32 score for every
slot of the worker's shard. Each step it rescores a window of
``refresh_size`` slots, decays every other entry toward the EMA mean
(``score ← μ + γ·(score − μ)``), draws the train batch from the whole
table (``p ∝ max(score + α·EMA, ε)``), and afterwards writes the trained
batch's fresh scores back (:func:`scatter_mean`).

The cursor of the window lives on the host, as the presampling stream's
does, so :func:`refresh_window` never waits for the device. Random numbers
are inputs: :func:`table_draw_inverse_cdf` takes its uniforms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mercury_tpu_torch.sampling.importance import importance_probs


class ScoreTableState(NamedTuple):
    """One worker's score memory."""

    scores: torch.Tensor  # [L] float32 — last known (decayed) score per slot
    cursor: int           # start of the next refresh window, on the host


def init_score_table(n_slots: int, device=None) -> ScoreTableState:
    """Uniform initial scores: before any refresh every slot is equally
    drawable."""
    return ScoreTableState(
        scores=torch.ones(n_slots, dtype=torch.float32, device=device), cursor=0)


def refresh_period(n_slots: int, refresh_size: int) -> int:
    """``ceil(L/R)``: steps for the window to sweep the whole shard."""
    return -(-n_slots // refresh_size)


def refresh_window(state: ScoreTableState, refresh_size: int) -> torch.Tensor:
    """Slots of the next refresh window, ``(cursor + arange(R)) % L``, as
    int64 on the table's device: every slot is visited once per
    ``ceil(L/R)`` windows."""
    n = state.scores.shape[0]
    return (state.cursor + torch.arange(refresh_size, device=state.scores.device)) % n


def advance_cursor(state: ScoreTableState, refresh_size: int) -> int:
    return (state.cursor + refresh_size) % state.scores.shape[0]


def decay_scores(scores: torch.Tensor, target, decay: float) -> torch.Tensor:
    """Age-decay every entry toward ``target`` (the EMA mean):
    ``target + (score − target)·γ``, op by op in float32."""
    return target + (scores - target) * decay


def scatter_mean(scores: torch.Tensor, slots: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """Write ``values`` into ``scores`` at ``slots``: a slot hit ``k``
    times gets the mean of its ``k`` values, untouched slots keep their
    score. Sums and counts are ``index_add_``s, so with three or more
    duplicates on the card the sum's order (atomics) varies in the last
    bit."""
    slots = slots.long()
    sums = torch.zeros_like(scores).index_add_(0, slots, values.to(torch.float32))
    counts = torch.zeros_like(scores).index_add_(
        0, slots, torch.ones_like(values, dtype=torch.float32))
    return torch.where(counts > 0, sums / counts.clamp(min=1.0), scores)


def table_probs(scores: torch.Tensor, ema_value, alpha: float = 0.5) -> torch.Tensor:
    """``p ∝ max(score + α·EMA, ε)`` over the whole table."""
    return importance_probs(scores, ema_value, alpha)


def table_draw_inverse_cdf(probs: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """The JAX package's inverse-CDF table draw on given ``[B]`` uniforms:
    ``searchsorted(cdf, u·cdf[−1])`` (left side), clipped to ``[0, L)``,
    int32."""
    cdf = torch.cumsum(probs, dim=0)
    u = uniforms.reshape(-1).to(torch.float32) * cdf[-1]
    sel = torch.searchsorted(cdf, u.contiguous())
    return sel.clamp_(0, probs.shape[0] - 1).to(torch.int32)
