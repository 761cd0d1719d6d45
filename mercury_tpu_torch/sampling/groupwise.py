"""The group-wise sliding-window importance sampler — the PyTorch
counterpart of ``mercury_tpu/sampling/groupwise.py`` (the reference's
``Groupwise_Sampler``).

A ``[L]`` importance for every slot of the worker's shard and a ``[L]``
tag of the refresh generation that wrote it. Each step rescores the next
window of the shard in order, wrapping at its end, and tags it with a new
generation; the batch is drawn from that newest group only, with
``p ∝ importance + mean(importance over the group)``.

The cursor and the generation live on the host, as the score table's
cursor does, so :func:`window_indices` never waits for the device. The draw
is by inverse CDF from given uniforms, as every draw of the port is.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class GroupwiseState(NamedTuple):
    importance: torch.Tensor  # [L] float32 — last known score a slot
    group: torch.Tensor       # [L] int32 — the generation that scored it
    cursor: int               # start of the next window, on the host
    generation: int           # the newest group's id, on the host


def init_groupwise(n_samples: int, device=None) -> GroupwiseState:
    """Every slot in generation 0 with importance 1."""
    return GroupwiseState(
        importance=torch.ones(n_samples, dtype=torch.float32, device=device),
        group=torch.zeros(n_samples, dtype=torch.int32, device=device),
        cursor=0, generation=0)


def window_indices(state: GroupwiseState, window: int) -> torch.Tensor:
    """The next window's slots, ``(cursor + arange(window)) % L``, int64."""
    n = state.importance.shape[0]
    return (state.cursor + torch.arange(window, device=state.importance.device)) % n


def update_importance(state: GroupwiseState, indices: torch.Tensor,
                      scores: torch.Tensor) -> GroupwiseState:
    """Write ``scores`` at ``indices``, tag them with the next generation
    and advance the cursor by ``len(indices)``.

    A slot given more than once (a window longer than the shard) keeps its
    last score: its last position in ``indices`` is taken by a
    ``scatter_reduce`` (amax) of the positions, which is deterministic on
    the card too. The JAX package leaves the winner to XLA's scatter, so
    the two packages are held to each other only for windows of at most
    ``L`` slots."""
    n = state.importance.shape[0]
    idx = indices.long()
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n,), -1, dtype=torch.long, device=idx.device).scatter_reduce_(
        0, idx, pos, "amax")
    hit = last >= 0
    generation = state.generation + 1
    importance = torch.where(hit, scores.to(torch.float32)[last.clamp(min=0)],
                             state.importance)
    group = torch.where(hit, torch.full_like(state.group, generation), state.group)
    return GroupwiseState(importance, group, (state.cursor + idx.shape[0]) % n, generation)


def group_probs(state: GroupwiseState) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``[L]`` draw distribution and the group's size ``M``: over the
    newest group ``max(importance + mean, 0)`` normalized, 0 elsewhere;
    uniform over the group when those sum to 0."""
    in_group = state.group == state.generation
    size = in_group.to(torch.float32).sum()
    mean = torch.where(in_group, state.importance, 0.0).sum() / size.clamp(min=1.0)
    scores = torch.where(in_group, state.importance + mean, 0.0).clamp(min=0.0)
    total = scores.sum()
    probs = torch.where(total > 0, scores / total.clamp(min=1e-12),
                        in_group.to(torch.float32) / size.clamp(min=1.0))
    return probs, size


def draw(state: GroupwiseState, uniforms: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One draw a uniform from the newest group by inverse CDF:
    ``#{j : cdf_j ≤ u}``, clamped to the last slot of nonzero probability
    (not to ``L − 1``: the slots after the group have p = 0, and a uniform
    at or above the float32 ``cdf[−1]`` would land on one, with weight 0).
    Returns the slots (int64), their ``p·M`` and the distribution."""
    probs, size = group_probs(state)
    cdf = torch.cumsum(probs, dim=0)
    idx = torch.searchsorted(cdf, uniforms.reshape(-1).contiguous(), right=True)
    slots = torch.arange(probs.shape[0], device=probs.device)
    last = torch.where(probs > 0, slots, 0).max()
    idx = torch.minimum(idx, last)
    return idx, probs[idx] * size, probs
