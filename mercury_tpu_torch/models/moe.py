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

Expert parallelism (``ep_axis``): :func:`bind_expert_group` hands the
layer an expert group of W ranks and cuts its experts to this rank's
``E/W``, experts ``[r·E/W, (r+1)·E/W)`` (JAX's ``P(ep_axis)`` on the
stacked leaves); the gate stays whole. Each rank routes its own tokens,
with the capacity of its own token count, and averages ``f_e`` and
``p̄_e`` over the group before their product (:func:`collectives.shard_mean`:
one all-reduce of both, its backward the gradient ÷ W), so every rank holds
the same loss. The local ``[E, C, D]`` buckets, viewed ``[W, E/W, C, D]``,
go out by one equal-split all-to-all (``sequence.AllToAll``, its own
inverse in the backward): rank j's slab j of every rank's buckets, its
experts' tokens from each source. The experts run on ``[E/W, W·C, D]``, and
a second all-to-all sends each output back to its token's rank. The
capacity is fixed, so every rank sends and receives the same bytes, bubble
ticks and empty buckets included. A forward with ``ep_axis`` and no bound
group raises.

The gradient, as JAX's ``shard_map`` transposes it: an expert's is whole
on the rank that holds it (its tokens' gradients come back through the
all-to-all's backward), while every other leaf (the gate, and whatever of
the model lies around the layer) holds only this rank's tokens' share,
which the caller sums over the group (``collectives.sum_grads_`` of every
parameter outside :func:`expert_leaf_names`; the pipeline's
``reduce_replicated_grads`` does so).
"""

from __future__ import annotations

import math
from typing import List, Optional, Set, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mercury_tpu_torch.parallel.collectives import shard_mean
from mercury_tpu_torch.parallel.mesh import GroupRef
from mercury_tpu_torch.parallel.sequence import all_to_all

# The stacked expert leaves an expert group splits (JAX's ``_EP_LEAVES``).
EXPERT_LEAVES = ("w_up", "b_up", "w_down", "b_down")


def expert_slice(full: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Experts ``[rank·E/size, (rank+1)·E/size)`` of a stacked expert leaf
    ``full`` ``[E, ...]``, a copy: rank ``rank``'s of an expert group of
    ``size`` (JAX's ``P(ep_axis)`` on the expert axis). ``E % size`` is
    refused with JAX's message."""
    e = full.shape[0]
    if e % size:
        raise ValueError(f"num_experts {e} not divisible by axis size {size}")
    return full.chunk(size, 0)[rank].clone()


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
    Flax's bare arrays. ``ep``, the expert group under ``ep_axis``, is
    set by :func:`bind_expert_group`, which leaves the rank's ``E/W``
    experts in the stacked leaves."""

    ep: Optional[GroupRef] = None

    def __init__(self, num_experts: int, d_model: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, ep_axis: Optional[str] = None):
        super().__init__()
        e, d, h = num_experts, d_model, mlp_ratio * d_model
        self.num_experts, self.capacity_factor, self.ep_axis = e, capacity_factor, ep_axis
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

    def bind(self, group: GroupRef) -> None:
        """Take ``group`` as the expert group and keep this rank's experts
        of the stacked leaves (the others' memory goes with them)."""
        if self.ep is not None:
            raise ValueError("this layer's expert group is bound already")
        for name in EXPERT_LEAVES:
            full = getattr(self, name).detach()
            setattr(self, name, nn.Parameter(expert_slice(full, group.rank, group.size)))
        self.ep = group

    def _route(self, tokens: torch.Tensor):
        """The router: float32 probabilities, each token's expert and gate
        value, and the load-balancing loss (its statistics averaged over
        the expert group under ``ep_axis``)."""
        probs = torch.softmax(self.gate(tokens).float(), dim=-1)
        expert_idx = probs.argmax(dim=-1)
        gate_val = probs.gather(1, expert_idx[:, None])[:, 0]
        onehot = F.one_hot(expert_idx, self.num_experts)
        frac, mean_prob = onehot.float().mean(0), probs.mean(0)
        if self.ep_axis is not None:
            frac, mean_prob = shard_mean(torch.stack((frac, mean_prob)), self.ep)
        aux = self.num_experts * (frac * mean_prob).sum()
        return expert_idx, gate_val, onehot, aux

    def capacity(self, n: int) -> int:
        """Slots an expert's bucket holds for a call of ``n`` tokens."""
        return int(math.ceil(self.capacity_factor * n / self.num_experts))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.ep_axis is not None and self.ep is None:
            raise ValueError(f"ep_axis={self.ep_axis!r} needs its expert group bound "
                             "(models.moe.bind_expert_group)")
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
        if self.ep_axis is None:
            out = self._expert_mlp(dispatch.view(e, cap, d)).reshape(e * cap, d)
        else:
            out = self._exchanged(dispatch.view(e, cap, d)).reshape(e * cap, d)
        y = out[flat] * (keep * gate_val)[:, None]
        return y.reshape(x.shape).to(x.dtype), aux

    def _exchanged(self, dispatch: torch.Tensor) -> torch.Tensor:
        """The expert-parallel dispatch of the local ``[E, C, D]`` buckets:
        out to the experts' ranks, through them, and back; ``[E, C, D]``."""
        e, cap, d = dispatch.shape
        w = self.ep.size
        e_loc = e // w
        # After the exchange the leading axis is the SOURCE rank, and the
        # E/W slabs under it are this rank's experts.
        received = all_to_all(dispatch.view(w, e_loc, cap, d), self.ep)
        out = self._expert_mlp(received.transpose(0, 1).reshape(e_loc, w * cap, d))
        out = out.view(e_loc, w, cap, d).transpose(0, 1)
        return all_to_all(out, self.ep).reshape(e, cap, d)

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


def _expert_layers(model: nn.Module) -> List[Tuple[str, MoEMLP]]:
    """The ``(name, layer)`` of every MoE layer of ``model`` built with
    ``ep_axis``."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, MoEMLP) and m.ep_axis is not None]


def expert_leaf_names(model: nn.Module) -> Set[str]:
    """The parameter names of ``model``'s expert-parallel stacked leaves:
    the ones an expert group splits."""
    return {f"{name}.{leaf}" if name else leaf for name, _ in _expert_layers(model)
            for leaf in EXPERT_LEAVES}


def bind_expert_group(model: nn.Module, group: GroupRef) -> nn.Module:
    """Hand every MoE layer of ``model`` built with ``ep_axis`` the expert
    group ``group`` and cut its experts to this rank's (``MoEMLP.bind``;
    ``num_experts % W`` refused with JAX's message). Build the optimizer
    after. Returns the model."""
    layers = _expert_layers(model)
    if not layers:
        raise ValueError("bind_expert_group needs a model built with moe_ep_axis")
    for _, layer in layers:
        layer.bind(group)
    return model


__all__ = ["EXPERT_LEAVES", "MoEMLP", "bind_expert_group", "expert_leaf_names",
           "expert_slice"]
