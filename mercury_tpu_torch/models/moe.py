"""The Switch mixture-of-experts MLP of ``mercury_tpu/models/moe.py``: a
top-1 router over ``E`` expert MLPs with fixed-capacity bucketing, and the
load-balancing loss ``E · Σ_e f_e · p̄_e`` (Switch eq. 4).

Each token goes to its router's argmax (the first maximum on a tie) and
its expert's output is scaled by that gate probability. A token lands at
the next free slot of its expert's bucket, counted by an integer cumsum in
token order; past the bucket's ``capacity = ceil(capacity_factor · N / E)``
slots (``N`` the tokens of this call) it is dropped: clipped to slot
``C − 1``, where it adds zero, and its output is zero. The experts run as
two batched products over the ``[E, C, D]`` buckets, ``x @ W`` with the
stacked ``w_up`` ``[E, D, H]`` and ``w_down`` ``[E, H, D]``, Flax's
layouts. :meth:`MoEMLP.reference` is the O(E·N) one-hot oracle without
capacity.

Precision, as the Flax module's ``compute_dtype``: under autocast the
tokens, the buckets, the expert products and the biases are in the
autocast dtype, the router's softmax in float32, and the output comes
back in the input's dtype.

Not ported yet: expert parallelism (``ep_axis``, the all-to-all dispatch
over a mesh axis); it raises ``ValueError``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

EP_NOT_PORTED = ("expert parallelism (moe_ep_axis) is not ported: ROADMAP.md, "
                 "Queue 1 item 8c")


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the Flax module computes in: autocast's where it is on for
    ``x``'s device, else ``x``'s own."""
    dev = x.device.type
    if torch.amp.is_autocast_available(dev) and torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


class MoEMLP(nn.Module):
    """Top-1 (Switch) mixture-of-experts MLP over token features:
    ``forward(x)`` of ``[..., D]`` returns ``(y, aux)``, ``y`` of ``x``'s
    shape and dtype and ``aux`` the float32 load-balancing loss. ``gate``
    is Flax's ``Dense``; ``w_up``, ``b_up``, ``w_down`` and ``b_down`` are
    Flax's bare arrays."""

    def __init__(self, num_experts: int, d_model: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, ep_axis: Optional[str] = None):
        super().__init__()
        if ep_axis is not None:
            raise ValueError(f"{EP_NOT_PORTED} (ep_axis={ep_axis!r})")
        e, d, h = num_experts, d_model, mlp_ratio * d_model
        self.num_experts, self.capacity_factor = e, capacity_factor
        self.gate = nn.Linear(d, e)
        self.w_up = nn.Parameter(torch.zeros(e, d, h))
        self.b_up = nn.Parameter(torch.zeros(e, h))
        self.w_down = nn.Parameter(torch.zeros(e, h, d))
        self.b_down = nn.Parameter(torch.zeros(e, d))

    @torch.no_grad()
    def flax_init(self, generator: Optional[torch.Generator]) -> None:
        """Flax's ``lecun_normal`` on the stacked kernels: the leading
        expert axis counts as a receptive field, so ``fan_in`` is E·D for
        ``w_up`` and E·H for ``w_down``; truncated at 2σ, as every Dense
        kernel of :func:`~mercury_tpu_torch.models.layers.init_weights`."""
        for w in (self.w_up, self.w_down):
            # 0.8796 is the std of a unit normal truncated at ±2.
            std = math.sqrt(w.shape[-1] / w.numel()) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    def _expert_mlp(self, tokens: torch.Tensor) -> torch.Tensor:
        """``[E, M, D]`` → ``[E, M, D]``: each expert's GELU MLP on its
        ``M`` rows, in ``tokens``' dtype."""
        dt = tokens.dtype
        h = torch.bmm(tokens, self.w_up.to(dt)) + self.b_up.to(dt)[:, None]
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.w_down.to(dt)) + self.b_down.to(dt)[:, None]

    def _route(self, tokens: torch.Tensor):
        """The router: float32 probabilities, each token's expert and gate
        value, and the load-balancing loss."""
        probs = torch.softmax(self.gate(tokens).float(), dim=-1)
        expert_idx = probs.argmax(dim=-1)
        gate_val = probs.gather(1, expert_idx[:, None])[:, 0]
        onehot = F.one_hot(expert_idx, self.num_experts)
        aux = self.num_experts * (onehot.float().mean(0) * probs.mean(0)).sum()
        return expert_idx, gate_val, onehot, aux

    def capacity(self, n: int) -> int:
        """Slots an expert's bucket holds for a call of ``n`` tokens."""
        return int(math.ceil(self.capacity_factor * n / self.num_experts))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        d = x.shape[-1]
        tokens = x.reshape(-1, d).to(_compute_dtype(x))
        n, e = tokens.shape[0], self.num_experts
        expert_idx, gate_val, onehot, aux = self._route(tokens)
        cap = self.capacity(n)
        # Each token's place in its expert's bucket, in token order: an
        # integer count (a float32 one stops counting past 2²⁴).
        pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
        keep = (pos < cap).to(tokens.dtype)
        slot = pos.clamp(0, cap - 1)
        # A dropped token adds zero at slot C − 1 of its expert.
        flat = expert_idx * cap + slot
        dispatch = tokens.new_zeros(e * cap, d).index_add(0, flat, tokens * keep[:, None])
        out = self._expert_mlp(dispatch.view(e, cap, d)).reshape(e * cap, d)
        y = out[flat] * (keep * gate_val)[:, None]
        return y.reshape(x.shape).to(x.dtype), aux

    def reference(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The O(E·N) oracle: every expert on every token, the routed
        output picked by a one-hot combine; no capacity, no drops."""
        d = x.shape[-1]
        tokens = x.reshape(-1, d).to(_compute_dtype(x))
        expert_idx, gate_val, onehot, aux = self._route(tokens)
        all_out = self._expert_mlp(tokens.expand(self.num_experts, *tokens.shape))
        y = torch.einsum("ne,end->nd", onehot.to(all_out.dtype), all_out)
        y = y * gate_val[:, None].to(y.dtype)
        return y.reshape(x.shape).to(x.dtype), aux


__all__ = ["EP_NOT_PORTED", "MoEMLP"]
