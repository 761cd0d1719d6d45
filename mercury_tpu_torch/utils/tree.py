"""The ZeRO layout of a flat vector — the port's copy of the jax-free
helpers of ``mercury_tpu/utils/tree.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def zero_chunk_size(n: int, w: int) -> int:
    """ZeRO-1's chunk: an ``n``-vector zero-padded to ``w × chunk`` and
    split one chunk a rank."""
    return -(-n // w)


def pad_to_chunks(vec: torch.Tensor, w: int) -> torch.Tensor:
    """``vec`` zero-padded and reshaped to ``[w, chunk]`` (row i is rank
    i's chunk)."""
    chunk = zero_chunk_size(vec.numel(), w)
    return F.pad(vec, (0, chunk * w - vec.numel())).view(w, chunk)
