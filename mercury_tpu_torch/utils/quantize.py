"""Stochastic gradient quantization — the PyTorch counterpart of
``mercury_tpu/utils/quantize.py``. The uniforms are an argument, drawn by
the step from its generator (the JAX function takes a key instead), so the
CPU tests can feed in the JAX package's."""

from __future__ import annotations

import torch


def stochastic_quantize(u: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``sign(a)·max|a|`` where ``u < |a|/max|a|``, else 0, with ``u``
    uniforms in [0, 1) of ``a``'s shape: unbiased, ``E[q] = a``. An
    all-zero ``a`` stays zero."""
    amax = a.abs().max()
    safe_max = torch.where(amax > 0, amax, torch.ones_like(amax))
    draw = u < a.abs() / safe_max
    return torch.sign(a) * amax * draw.to(a.dtype)


def sparsity(a: torch.Tensor) -> torch.Tensor:
    """The share of nonzero elements, in float32."""
    return (a != 0).to(torch.float32).mean()
