"""Fully sharded parameters over a model group, for any model family — the
counterpart of ``fsdp_shardings`` and ``shard_params_fsdp`` in
``mercury_tpu/parallel/fsdp.py`` (the ZeRO-3 analogue).

**The split rule** is the JAX package's: a parameter of at least
``min_size`` (1024) elements is split along its largest dimension
divisible by the group's size ``F``, the first of equal ones; a smaller or
indivisible one stays replicated. The rule reads the parameter's Flax
shape (``models/convert.flax_leaves``) and maps the chosen dimension back
to the torch layout: a ``[3, 3, 64, 64]`` Flax conv kernel splits on
``Cin`` (its first 64), where the torch ``[64, 64, 3, 3]`` would pick
``Cout``. So rank ``r`` of the group holds exactly the elements of the JAX
mesh's device ``r`` along the axis.

**The forward.** A forward pre-hook on each module that owns a sharded
parameter all-gathers it over the group just before the module runs and
puts the whole tensor in the parameter's place; a forward hook puts the
shard back. The gather is an autograd function (:class:`GatherParam`)
whose backward reduce-scatters the gradient with a mean over the group,
so the shard's ``.grad`` is this rank's slice of the group's mean
gradient. A model whose code reads a submodule's weights without calling
it (the BiLSTM's cells) names, in its ``fsdp_gather_at``, the module
whose call gathers them. A module
recomputed under ``remat`` gathers again in the backward.

**The compute.** Every rank of a group computes its worker's whole batch,
so its BN statistics, its scores and its draw stay the worker's, and every
replicated parameter gets the same gradient on every rank. Splitting the
batch over the group is a later performance step.

**Memory.** A rank keeps only its shards, and Adam's moments follow them:
its persistent parameter and moment bytes are what the rule gives.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from mercury_tpu_torch.parallel.mesh import GroupRef, ParamSharding, gather_dim, shard_of

MIN_SIZE = 1024


def split_axis(shape: Tuple[int, ...], n: int, min_size: int = MIN_SIZE):
    """The JAX rule on a Flax shape: the index of the largest dimension
    divisible by ``n`` (the first of equal ones), or None when the leaf
    has fewer than ``min_size`` elements or no such dimension."""
    size = 1
    for d in shape:
        size *= d
    if size < min_size:
        return None
    divisible = [i for i, d in enumerate(shape) if d % n == 0]
    if not divisible:
        return None
    return max(divisible, key=lambda i: shape[i])


def fsdp_dims(model: torch.nn.Module, n: int, min_size: int = MIN_SIZE) -> Dict[str, int]:
    """The torch dimension each sharded parameter splits along."""
    from mercury_tpu_torch.models.convert import flax_leaves

    params = dict(model.named_parameters())
    dims = {}
    for name, _, axes in flax_leaves(model):
        flax_shape = tuple(params[name].shape[a] for a in axes)
        i = split_axis(flax_shape, n, min_size)
        if i is not None:
            dims[name] = axes[i]
    return dims


class GatherParam(torch.autograd.Function):
    """The whole parameter from the group's shards along ``dim``; the
    backward is the group-mean reduce-scatter of the gradient. A ``meta``
    shard (a FLOP count) gives a ``meta`` tensor of the whole shape."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, dim: int, group: GroupRef) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        if shard.is_meta:
            return torch.cat([shard] * group.size, dim=dim)
        full = gather_dim(shard, dim, group)
        if shard.dim() == 4 and not shard.is_contiguous() and shard.is_contiguous(
                memory_format=torch.channels_last):
            # The card's conv weights are channels_last: so is the whole one,
            # and cuDNN picks the unsharded run's algorithm.
            full = full.contiguous(memory_format=torch.channels_last)
        return full

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        group = ctx.group
        if grad.is_meta:
            return grad.chunk(group.size, ctx.dim)[group.rank], None, None
        chunks = grad.chunk(group.size, ctx.dim)
        # Flat on both sides: gloo wants the output [C] of an input [W·C].
        rows = torch.cat([c.reshape(-1) for c in chunks])
        out = rows.new_empty((chunks[0].numel(),))
        dist.reduce_scatter_tensor(out, rows, op=dist.ReduceOp.SUM, group=group.group)
        return out.view(chunks[0].shape).div_(group.size), None, None


def _gather_hook(root: torch.nn.Module, args) -> None:
    """Forward pre-hook: the sharded parameters ``root`` gathers replaced
    in their modules by the whole tensors (once, if ``root`` is entered
    again before it returns)."""
    if root._fsdp_shards is not None:
        return
    saved = []
    for owner, leaf, dim in root._fsdp_params:
        shard = owner._parameters[leaf]
        saved.append((owner, leaf, shard))
        owner._parameters[leaf] = GatherParam.apply(shard, dim, root._fsdp_group)
    root._fsdp_shards = saved


def _restore_hook(root: torch.nn.Module, args, output) -> None:
    """Forward hook (run on an exception too): the shards back in place."""
    saved, root._fsdp_shards = root._fsdp_shards, None
    for owner, leaf, shard in saved or ():
        owner._parameters[leaf] = shard


def _gather_root(model: torch.nn.Module, owner: str) -> str:
    """The module whose call gathers ``owner``'s parameters: the owner,
    unless the model's ``fsdp_gather_at`` (a map of module-name prefixes
    to the module that gathers for them) names another, for modules whose
    weights the model reads without calling them."""
    for prefix, root in getattr(model, "fsdp_gather_at", {}).items():
        if owner.startswith(prefix):
            return root
    return owner


def shard_model_fsdp(model: torch.nn.Module, group: GroupRef,
                     min_size: int = MIN_SIZE) -> torch.nn.Module:
    """Cut ``model`` (the whole model, the same weights on every rank of
    the group) to this rank's FSDP shards, in place, and hook the gathers;
    returns the model with its :class:`ParamSharding` as
    ``model.param_sharding``."""
    dims = fsdp_dims(model, group.size, min_size)
    roots: Dict[str, List[Tuple[torch.nn.Module, str, int]]] = {}
    for name, dim in dims.items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        full = getattr(module, leaf).detach()
        setattr(module, leaf, torch.nn.Parameter(shard_of(full, dim, group.rank, group.size)))
        roots.setdefault(_gather_root(model, owner), []).append((module, leaf, dim))
    for root, params in roots.items():
        module = model.get_submodule(root)
        module._fsdp_params, module._fsdp_group, module._fsdp_shards = params, group, None
        module.register_forward_pre_hook(_gather_hook)
        module.register_forward_hook(_restore_hook, always_call=True)
    model.param_sharding = ParamSharding(dims, group)
    return model


__all__ = ["MIN_SIZE", "split_axis", "fsdp_dims", "GatherParam", "shard_model_fsdp"]
