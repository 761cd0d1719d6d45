"""The step's collectives over ``torch.distributed`` — the PyTorch
counterpart of ``mercury_tpu/parallel/collectives.py``
(``allreduce_mean_tree``, ``psum_stats``, the int8 wire and ZeRO's two
halves) and of the ``lax.pmean`` in Flax's synced BatchNorm.

Every function takes the process group (``None``: the default group) and
issues no collective at one rank, with or without a process group. Each is
the identity there, except the two halves of the int8 wire, which quantize
at one rank as the JAX functions do. Ranks must call them in the same
order, as they do when they run the same step.

The int8 wire (``grad_compression="int8"``) holds the JAX arithmetic: one
scale a row, ``max(max|row|, 1e-30)/127``, and stochastic rounding
``clip(floor(y) + (u < y − floor(y)), −127, 127)`` with the uniforms ``u``
as an argument. Gloo takes CUDA tensors in ``all_to_all_single``,
``all_gather_into_tensor`` and ``reduce_scatter_tensor``, int8 included
(torch 2.11 on the H100, ``chip_smoke.py`` phase 12), so every backend
issues the same calls.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mercury_tpu_torch.utils.tree import pad_to_chunks


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


def host_flag_device(group=None) -> torch.device:
    """Where a small bookkeeping collective's tensor lives: this rank's
    card under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


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


def stochastic_round(u: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unbiased rounding of ``y`` to the int8 grid, ``u`` uniforms of
    ``y``'s shape: ``E[round(y)] = y`` inside ±127."""
    lo = torch.floor(y)
    return torch.clamp(lo + (u < y - lo).to(y.dtype), -127, 127).to(torch.int8)


def quantize_rows(u: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 of ``x`` ``[R, ...]`` with one scale a leading row, and the
    ``[R, 1, …]`` float32 scales."""
    dims = tuple(range(1, x.dim()))
    scale = torch.clamp(x.abs().amax(dim=dims, keepdim=True), min=1e-30) / 127.0
    return stochastic_round(u, x / scale), scale


def compressed_psum_scatter_mean(rows: torch.Tensor, u: torch.Tensor, group=None
                                 ) -> torch.Tensor:
    """The mean over the ranks of this rank's row of ``rows`` ``[W, C]``,
    int8 on the wire: each row quantized (``u`` ``[W, C]``), two
    ``all_to_all_single`` (the int8 rows, then the scales), the mean in
    float32. ``[C]`` float32; at one rank the dequantized row."""
    q, scale = quantize_rows(u, rows)
    if world(group) > 1:
        q_all, s_all = torch.empty_like(q), torch.empty_like(scale)
        dist.all_to_all_single(q_all, q, group=group)
        dist.all_to_all_single(s_all, scale, group=group)
        q, scale = q_all, s_all
    return (q.to(torch.float32) * scale).mean(dim=0)


def compressed_all_gather(chunk: torch.Tensor, u: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``[C]`` chunk, concatenated, int8 on the wire: the
    chunk quantized with one scale (``u`` ``[C]``), two all-gathers (the
    int8 chunk, then the scale), dequantized. ``[W·C]`` float32; at one
    rank the dequantized chunk."""
    q, scale = quantize_rows(u[None], chunk[None])
    w = world(group)
    if w > 1:
        gq = q.new_empty((w, q.shape[1]))
        gs = scale.new_empty((w, 1))
        dist.all_gather_into_tensor(gq, q, group=group)
        dist.all_gather_into_tensor(gs, scale, group=group)
        q, scale = gq, gs
    return (q.to(torch.float32) * scale).reshape(-1)


def allreduce_quantizes(group=None) -> bool:
    """Whether :func:`compressed_allreduce_mean` quantizes: across ranks
    only, as in the JAX package; at one rank it is the identity (ZeRO's two
    halves quantize there all the same)."""
    return world(group) > 1


def compressed_allreduce_mean(vec: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
                              group=None) -> torch.Tensor:
    """The mean over the ranks of a float32 vector, int8 on both halves of
    the wire: zero-padded to ``[W, chunk]``,
    :func:`compressed_psum_scatter_mean` (``u1`` ``[W, chunk]``), then
    :func:`compressed_all_gather` of the mean chunk (``u2`` ``[chunk]``).
    ``vec`` itself at one rank."""
    if not allreduce_quantizes(group):
        return vec
    w = world(group)
    mine = compressed_psum_scatter_mean(pad_to_chunks(vec, w), u1, group)
    return compressed_all_gather(mine, u2, group)[:vec.numel()]


def psum_scatter_mean(rows: torch.Tensor, group=None) -> torch.Tensor:
    """ZeRO's gradient half: this rank's row of the mean over the ranks of
    ``rows`` ``[W, C]``, by one ``reduce_scatter_tensor`` (SUM, then ÷W);
    ``rows[0]`` at one rank."""
    w = world(group)
    if w == 1:
        return rows[0]
    out = rows.new_empty(rows.shape[1:])
    dist.reduce_scatter_tensor(out, rows.reshape(-1), op=dist.ReduceOp.SUM, group=group)
    return out.div_(w)


def all_gather_flat(chunk: torch.Tensor, group=None) -> torch.Tensor:
    """ZeRO's update half: every rank's ``[C]`` chunk concatenated,
    ``[W·C]``, by one ``all_gather_into_tensor``; ``chunk`` at one rank."""
    w = world(group)
    if w == 1:
        return chunk
    out = chunk.new_empty((w * chunk.numel(),))
    dist.all_gather_into_tensor(out, chunk, group=group)
    return out


# ------------------------------------------------------- host collectives
# Two small collectives of the host runtime, on ``host_flag_device``: the
# cross-rank telemetry's all-gather at the log tick and the supervisor's
# ladder agreement a tick. Their values are host numbers in and out. Under
# NCCL the tensor is on the card, so the collective runs on a side stream
# of its own: reading its result waits for that stream alone, never for
# the step's kernels queued on the current stream.


_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _host_collective(values, dtype: torch.dtype, run, group) -> List:
    """``run(tensor)`` on a tensor of ``values`` on ``host_flag_device``;
    the result as a list of host numbers."""
    dev = host_flag_device(group)
    if dev.type != "cuda":
        return run(torch.tensor(list(values), dtype=dtype)).tolist()
    side = _SIDE_STREAMS.get(dev.index)
    if side is None:
        side = _SIDE_STREAMS[dev.index] = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        out = run(torch.tensor(list(values), dtype=dtype, device=dev)).cpu()
    return out.tolist()


def allgather_floats(values: Sequence[float], group=None) -> List[List[float]]:
    """Every rank's row of ``len(values)`` floats, in rank order, by one
    ``all_gather_into_tensor`` of float32 (the JAX package's
    ``process_allgather`` dtype; NaN passes through). Ranks must send rows
    of one width; ``[values]`` rounded to float32 at one rank."""
    w, n = world(group), len(values)

    def run(t: torch.Tensor) -> torch.Tensor:
        if w == 1:
            return t[None]
        out = t.new_empty((w * n,))
        dist.all_gather_into_tensor(out, t, group=group)
        return out.view(w, n)

    if w == 1:
        return [torch.tensor(list(values), dtype=torch.float32).tolist()]
    return _host_collective(values, torch.float32, run, group)


def allreduce_max_ints(values: Sequence[int], group=None) -> List[int]:
    """The elementwise maximum over the ranks of a few integers, by one
    all-reduce (MAX) of int64; ``values`` at one rank."""
    if world(group) == 1:
        return [int(v) for v in values]

    def run(t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t

    return [int(v) for v in _host_collective(values, torch.int64, run, group)]
