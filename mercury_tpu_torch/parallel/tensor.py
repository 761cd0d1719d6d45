"""Tensor parallelism for the transformer family over a model group — the
counterpart of ``transformer_tp_shardings`` and ``shard_params_tp`` in
``mercury_tpu/parallel/tensor.py``.

The JAX package annotates the Megatron layout as parameter shardings and
lets GSPMD insert the collectives. Here the layout is the same and the
collectives are Megatron's two operators, written out
(``models/transformer.py`` calls them):

- ``f`` (:func:`copy_to_model`): the identity forward, an all-reduce of
  the gradient in the backward, before each column-parallel product;
- ``g`` (:func:`reduce_from_model`): an all-reduce forward, the identity
  backward, after each row-parallel product.

So a block all-reduces twice in a forward (after ``proj`` and ``fc2``)
and twice in a backward (before ``query/key/value`` and ``fc1``).

The split follows the JAX package's suffix lists, read on each
parameter's Flax name (``models/convert.flax_leaves``): inside a
``block``, the ``query``, ``key``, ``value`` and ``Dense_0`` (``fc1``)
kernels are column-parallel — split on their output features, so the
torch weight ``[out, in]`` on dim 0 and its bias with it — and ``proj``
and ``Dense_1`` (``fc2``) row-parallel, split on their input features
(the torch weight's dim 1); their bias stays whole and is added once,
after the all-reduce. With ``num_heads % T == 0`` each rank holds
``num_heads / T`` whole heads. Everything else (the embedding, the
LayerNorms, ``pos_embed``, the head, the experts) is replicated, as in
JAX, where those names match no suffix.

The replicated leaves get the same gradient on every rank of the group:
``f``'s all-reduce makes the residual stream's gradient whole. Adam's
moments live on the local shards (``opt_sharding_like`` by construction).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from mercury_tpu_torch.parallel.mesh import GroupRef, ParamSharding, shard_of

# The JAX package's suffixes of a block's flattened Flax path.
_COLUMN_KERNELS = ("query/kernel", "key/kernel", "value/kernel", "Dense_0/kernel")
_COLUMN_BIASES = ("query/bias", "key/bias", "value/bias", "Dense_0/bias")
_ROW_KERNELS = ("proj/kernel", "Dense_1/kernel")


def _summed(x: torch.Tensor, group: GroupRef) -> torch.Tensor:
    """``x`` summed over the group in float32, back in ``x``'s dtype. A
    ``meta`` tensor (a FLOP count) passes through."""
    if group.size == 1 or x.is_meta:
        return x
    out = x.to(torch.float32).contiguous()
    if out is x:
        out = out.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.group)
    return out.to(x.dtype)


class CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduced gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: GroupRef) -> torch.Tensor:
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _summed(grad, ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: all-reduced forward, identity gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: GroupRef) -> torch.Tensor:
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_model(x: torch.Tensor, group: GroupRef) -> torch.Tensor:
    return CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: GroupRef) -> torch.Tensor:
    return ReduceFromModel.apply(x, group)


def tp_dims(model: torch.nn.Module) -> Dict[str, int]:
    """The torch dimension each block matmul's parameter splits along,
    from the JAX package's suffix lists on its Flax path."""
    from mercury_tpu_torch.models.convert import flax_leaves

    dims = {}
    for name, path, axes in flax_leaves(model):
        flax = "/".join(path)
        if "block" not in flax:
            continue
        if flax.endswith(_COLUMN_KERNELS):
            dims[name] = axes[1]  # P(None, model) on [in, out]
        elif flax.endswith(_COLUMN_BIASES):
            dims[name] = axes[0]  # P(model)
        elif flax.endswith(_ROW_KERNELS):
            dims[name] = axes[0]  # P(model, None)
    return dims


def shard_model_tp(model: torch.nn.Module, group: GroupRef) -> torch.nn.Module:
    """Cut ``model`` (the whole model, the same weights on every rank of
    the group) to this rank's Megatron shards, in place, and hand each
    block the group; returns the model with its :class:`ParamSharding`
    as ``model.param_sharding``."""
    heads = model.blocks[0].num_heads
    if heads % group.size != 0:
        raise ValueError(f"num_heads={heads} must be divisible by "
                         f"tensor_parallel={group.size}")
    dims = tp_dims(model)
    for name, dim in dims.items():
        module_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(module_name)
        full = getattr(module, leaf).detach()
        setattr(module, leaf, torch.nn.Parameter(shard_of(full, dim, group.rank, group.size)))
    for block in model.blocks:
        block.tp = group
    model.param_sharding = ParamSharding(dims, group)
    return model


__all__ = ["CopyToModel", "ReduceFromModel", "copy_to_model", "reduce_from_model",
           "tp_dims", "shard_model_tp"]
