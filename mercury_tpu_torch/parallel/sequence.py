"""Attention of the port's Transformer: the dense scaled-dot-product
attention of ``mercury_tpu/parallel/sequence.py``.

Plain PyTorch on purpose: the JAX package computes attention outside any
Pallas kernel. ``dense_attention`` keeps its rounding: both products in the
input's dtype, the scores in float32 scaled by ``1/sqrt(d)``, and the
softmax probabilities cast to ``v``'s dtype before the second product
(``scaled_dot_product_attention`` rounds a bf16 input otherwise). The
sequence-parallel variants (ring, zigzag, Ulysses) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
SP_NOT_PORTED = ("sequence parallelism (sp_axis) is not ported: ROADMAP.md, "
                 "Queue 1 item 8")


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Scaled-dot-product attention; ``q``/``k``/``v`` ``[B, L, H, D]``,
    returns ``[B, L, H, D]`` in ``q``'s dtype."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    # sqrt is correctly rounded, so float32(sqrt(d)) is JAX's float32 sqrt.
    scores = scores / math.sqrt(d)
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        mask = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
              sp_axis: Optional[str] = None, sp_impl: str = "ring") -> torch.Tensor:
    """The JAX dispatcher's dense arm; any ``sp_axis`` raises."""
    if sp_axis is not None:
        raise ValueError(f"{SP_NOT_PORTED} (sp_axis={sp_axis!r}, sp_impl={sp_impl!r})")
    return dense_attention(q, k, v, causal=causal)


__all__ = ["NEG_INF", "attention", "dense_attention"]
