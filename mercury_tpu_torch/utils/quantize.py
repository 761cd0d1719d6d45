"""Stochastic gradient quantization — the PyTorch counterpart of
``mercury_tpu/utils/quantize.py``. The uniforms are an argument, drawn by
the step from its generator (the JAX function takes a key instead), so the
CPU tests can feed in the JAX package's. A leaf split over a model group
(``tensor_parallel``, ``fsdp_parallel``) is quantized shard by shard with
the whole leaf's ``max|a|``, which the caller gathers, as GSPMD reduces
the JAX function's over the whole logical leaf."""

from __future__ import annotations

from typing import Optional

import torch


def stochastic_quantize(u: torch.Tensor, a: torch.Tensor,
                        amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sign(a)·max|a|`` where ``u < |a|/max|a|``, else 0, with ``u``
    uniforms in [0, 1) of ``a``'s shape: unbiased, ``E[q] = a``. An
    all-zero ``a`` stays zero. ``amax`` is the whole leaf's ``max|a|``
    when ``a`` is a shard of it (default: ``a``'s own)."""
    if amax is None:
        amax = a.abs().max()
    safe_max = torch.where(amax > 0, amax, torch.ones_like(amax))
    draw = u < a.abs() / safe_max
    return torch.sign(a) * amax * draw.to(a.dtype)


def sparsity(a: torch.Tensor) -> torch.Tensor:
    """The share of nonzero elements, in float32."""
    return (a != 0).to(torch.float32).mean()


def nonzeros(a: torch.Tensor) -> torch.Tensor:
    """The count of nonzero elements, in float32 (exact below 2²⁴): a
    shard's share of a split leaf's :func:`sparsity`."""
    return (a != 0).to(torch.float32).sum()
