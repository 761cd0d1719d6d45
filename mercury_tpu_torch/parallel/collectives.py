"""The step's collectives over ``torch.distributed`` — the PyTorch
counterpart of ``mercury_tpu/parallel/collectives.py``
(``allreduce_mean_tree``, ``psum_stats``) and of the ``lax.pmean`` in
Flax's synced BatchNorm.

Every function takes the process group (``None``: the default group) and
is the identity at one rank: it returns its input and issues no collective,
with or without a process group. Ranks must call them in the same order,
as they do when they run the same step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def world(group=None) -> int:
    """Ranks in ``group``; 1 without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def allreduce_mean_(tensors: Sequence[torch.Tensor], group=None
                    ) -> Sequence[torch.Tensor]:
    """Replace each tensor by its mean over the ranks, in place: one
    all-reduce (SUM, then ÷W) over a flat bucket for each dtype, the bucket
    at least float32. Used for the gradients and the BN running
    statistics."""
    w = world(group)
    if w == 1:
        return tensors
    buckets: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault(t.dtype, []).append(t)
    for dtype, ts in buckets.items():
        flat_dtype = torch.promote_types(dtype, torch.float32)
        flat = torch.cat([t.reshape(-1).to(flat_dtype) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(w)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view(t.shape))
    return tensors


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``x`` summed over the ranks by one all-reduce."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def allreduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """A summed copy of ``x`` over the ranks (not differentiable); ``x``
    itself at one rank."""
    return x if world(group) == 1 else _summed(x, group)


def gather_to_rank0(obj: Any, group=None) -> Optional[List[Any]]:
    """Every rank's picklable ``obj`` on the group's first rank, in rank
    order (``gather_object``, on gloo and NCCL); None on the other ranks;
    ``[obj]`` at one rank."""
    if world(group) == 1:
        return [obj]
    objs = [None] * world(group) if rank(group) == 0 else None
    dst = 0 if group is None else dist.get_global_rank(group, 0)
    dist.gather_object(obj, objs, dst=dst, group=group)
    return objs


def psum_stats(sum_value: torch.Tensor, count: torch.Tensor, group=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sums over the ranks of a (sum, count) pair, as one all-reduce of
    the two in float32: the exchange behind the global pool mean."""
    if world(group) == 1:
        return sum_value, count
    pair = _summed(torch.stack([sum_value.to(torch.float32), count.to(torch.float32)]), group)
    return pair[0], pair[1]


class AllReduceMean(torch.autograd.Function):
    """``SUM/W`` over the ranks, differentiable: the backward is ``SUM/W``
    of the incoming gradient, the transpose of ``lax.pmean`` in the JAX
    step's ``shard_map``. Call it through :func:`all_reduce_mean`."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.group = group
        return _summed(x, group).div_(world(group))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _summed(grad, ctx.group).div_(world(ctx.group)), None


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """:class:`AllReduceMean` of ``x``; ``x`` itself at one rank."""
    if world(group) == 1:
        return x
    return AllReduceMean.apply(x, group)
