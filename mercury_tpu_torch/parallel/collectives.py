"""The step's collectives over ``torch.distributed`` — the PyTorch
counterpart of ``mercury_tpu/parallel/collectives.py``
(``allreduce_mean_tree``, ``psum_stats``, the int8 wire and ZeRO's two
halves) and of the ``lax.pmean`` in Flax's synced BatchNorm.

Every function takes the process group (``None``: the default group) and
issues no collective at one rank, with or without a process group. Each is
the identity there, except the two halves of the int8 wire, which quantize
at one rank as the JAX functions do. Ranks must call them in the same
order, as they do when they run the same step.

The int8 wire (``grad_compression="int8"``) holds the arithmetic of the
compiled JAX step: one scale a row, ``max(max|row|, 1e-30)·fl32(1/127)``
(XLA folds the JAX wire's ``÷127`` into that multiply), stochastic rounding
``clip(floor(y) + (u < y − floor(y)), −127, 127)`` with the uniforms ``u``
as an argument, and the reduce-scatter's mean a running fused multiply-add
over the rows times ``fl32(1/W)``, flat and per leaf alike. Gloo takes
CUDA tensors in ``all_to_all_single``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor``, int8 included (torch 2.11 on the H100,
``chip_smoke.py`` phase 12), so every backend issues the same calls.
Under a second mesh axis the wire is per leaf
(:func:`compressed_pmean_tree_sharded`, below).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mercury_tpu_torch.utils.tree import pad_to_chunks

if TYPE_CHECKING:  # parallel/mesh.py imports this module
    from mercury_tpu_torch.parallel.mesh import GroupRef


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


class ShardSum(torch.autograd.Function):
    """JAX's ``psum`` of each rank's share into a value every rank then
    holds alike: the sum over the ranks. Everything after it is computed
    alike on every rank, so each rank's copy of the loss sends the same
    gradient, and the exact transpose hands it to each rank's share
    unchanged: the backward issues no collective."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class ShardMean(torch.autograd.Function):
    """JAX's ``pmean`` of the ranks' shares into a value every rank then
    holds alike: ``SUM/W``; its gradient, the same on every rank, divided
    by W into each share (the exact transpose, no collective; compare
    :class:`AllReduceMean`, whose backward sums the ranks' gradients)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.w = world(group)
        return _summed(x, group).div_(ctx.w)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad / ctx.w, None


def sum_grads_(params: Sequence[torch.Tensor], ref: GroupRef) -> None:
    """Sum the gradients of ``params`` over the ranks of ``ref``, in one
    flat all-reduce: a missing gradient counts as zeros, and every
    parameter ends with the sum set as its ``grad``. Nothing in a group of
    one."""
    if ref.size == 1:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, group=ref.group)
    for p, part in zip(params, flat.split([p.numel() for p in params])):
        p.grad = part.view_as(p)


def shard_sum(x: torch.Tensor, ref: GroupRef) -> torch.Tensor:
    """:class:`ShardSum` of ``x`` over the ranks of ``ref``; ``x`` itself
    in a group of one."""
    return x if ref.size == 1 else ShardSum.apply(x, ref.group)


def shard_mean(x: torch.Tensor, ref: GroupRef) -> torch.Tensor:
    """:class:`ShardMean` of ``x`` over the ranks of ``ref``; ``x`` itself
    in a group of one."""
    return x if ref.size == 1 else ShardMean.apply(x, ref.group)


def stochastic_round(u: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unbiased rounding of ``y`` to the int8 grid, ``u`` uniforms of
    ``y``'s shape: ``E[round(y)] = y`` inside ±127."""
    lo = torch.floor(y)
    return torch.clamp(lo + (u < y - lo).to(y.dtype), -127, 127).to(torch.int8)


# The float32 nearest 1/127. XLA folds the JAX wire's ``max(…, 1e-30) /
# 127.0`` into a multiply by the constant's reciprocal, so the compiled
# JAX step's chunk scales are on this product's grid, one ulp off the
# quotient for about one scale in twenty.
_INV_127 = float(torch.tensor(1.0, dtype=torch.float32) / 127.0)


def _chunk_scales(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-30) * _INV_127


def _dequantized_mean(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``mean(q·scale, axis=0)`` of ``[W, …]`` int8 rows and their scales
    as XLA compiles JAX's: a running fused multiply-add from the first row
    (float64 holds an int8·float32 product and its sum exactly), times the
    float32 nearest 1/W."""
    acc = q[0].to(torch.float32) * scale[0]
    for w in range(1, q.shape[0]):
        acc = (q[w].to(torch.float64) * scale[w].to(torch.float64)
               + acc.to(torch.float64)).to(torch.float32)
    return acc * float(torch.tensor(1.0, dtype=torch.float32) / q.shape[0])


def quantize_rows(u: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 of ``x`` ``[R, ...]`` with one scale a leading row, and the
    ``[R, 1, …]`` float32 scales (:func:`_chunk_scales`)."""
    dims = tuple(range(1, x.dim()))
    scale = _chunk_scales(x.abs().amax(dim=dims, keepdim=True))
    return stochastic_round(u, x / scale), scale


def compressed_psum_scatter_mean(rows: torch.Tensor, u: torch.Tensor, group=None
                                 ) -> torch.Tensor:
    """The mean over the ranks of this rank's row of ``rows`` ``[W, C]``,
    int8 on the wire: each row quantized (``u`` ``[W, C]``), two
    ``all_to_all_single`` (the int8 rows, then the scales), the mean in
    float32 (:func:`_dequantized_mean`). ``[C]`` float32; at one rank the
    dequantized row."""
    q, scale = quantize_rows(u, rows)
    if world(group) > 1:
        q_all, s_all = torch.empty_like(q), torch.empty_like(scale)
        dist.all_to_all_single(q_all, q, group=group)
        dist.all_to_all_single(s_all, scale, group=group)
        q, scale = q_all, s_all
    return _dequantized_mean(q, scale)


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
    """Whether :func:`compressed_allreduce_mean` and the per-leaf wire
    quantize over ``group`` (the data group under a second mesh axis):
    across ranks only, as in the JAX package; at one rank they are the
    identity (ZeRO's two halves quantize there all the same)."""
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


# ------------------------------------------------- the per-leaf int8 wire
# The int8 wire that composes with a second mesh axis (JAX's
# ``compressed_pmean_nd`` and ``compressed_pmean_tree_sharded``): a leaf
# keeps its shape, and only its chunk dim — one the sharding does not
# claim — is cut into W wire chunks, so a rank sends its own shard. A wire
# chunk's scale is max|x| over the chunk of the whole logical leaf: on a
# leaf split over the model group, a MAX all-reduce over that group, one a
# phase for every split leaf at once. The leaves' int8 payloads and scales
# each ride one collective a phase on the data group.


def wire_chunk_dim(shape: Tuple[int, ...], spec) -> Optional[int]:
    """JAX's ``wire_chunk_dim``: the largest dim of ``shape`` that
    ``spec`` (a sequence of a mesh axis name or None a dim, or None for a
    replicated leaf) does not claim, the first of equal ones; None when
    every dim is claimed (the leaf takes the plain mean); 0 for a scalar.
    ``shape`` is the leaf's layout in the JAX package (Flax's)."""
    if not shape:
        return 0
    banned = {i for i, entry in enumerate(spec or ()) if entry is not None}
    free = [i for i in range(len(shape)) if i not in banned]
    if not free:
        return None
    return max(free, key=lambda i: shape[i])


def _wire_rows(x: torch.Tensor, dim: int, w: int) -> torch.Tensor:
    """``x`` with ``dim`` moved first, zero-padded to ``w·c`` and cut into
    ``[w, c, *rest]``."""
    g = torch.movedim(x.to(torch.float32), dim, 0)
    c = -(-g.shape[0] // w)
    pad = c * w - g.shape[0]
    if pad:
        g = torch.cat([g, g.new_zeros((pad, *g.shape[1:]))])
    return g.reshape(w, c, *g.shape[1:])


def model_group_max_(amax: torch.Tensor, split: Sequence[bool], model) -> None:
    """Each row of ``amax`` ``[n, k]`` whose leaf is ``split`` replaced by
    its MAX over ``model``'s ranks (a ``GroupRef``): one all-reduce."""
    rows = [i for i, s in enumerate(split) if s]
    if model is None or model.size == 1 or not rows:
        return
    part = amax[rows].contiguous()
    dist.all_reduce(part, op=dist.ReduceOp.MAX, group=model.group)
    amax[rows] = part


def _pmean_leaves(leaves: Sequence[torch.Tensor], dims: Sequence[int],
                  split: Sequence[bool], u1s: Sequence[torch.Tensor],
                  u2s: Sequence[torch.Tensor], group, model) -> List[torch.Tensor]:
    """:func:`compressed_pmean_nd` of several leaves at once (at least one,
    over a group of more than one rank): each phase's scales, the model
    group's MAX of them, and its int8 payloads and scales in one
    collective each."""
    w = world(group)
    rows = [_wire_rows(x, d, w) for x, d in zip(leaves, dims)]
    # Phase 1, the reduce-scatter: worker j receives every worker's chunk j.
    amax = torch.stack([r.abs().amax(dim=tuple(range(1, r.dim()))) for r in rows])
    model_group_max_(amax, split, model)
    scales = _chunk_scales(amax)                                   # [n, w]
    qs = [stochastic_round(u, r / s.view(w, *[1] * (r.dim() - 1)))
          for r, s, u in zip(rows, scales, u1s)]
    sizes = [q[0].numel() for q in qs]
    q_all = torch.empty((w, sum(sizes)), dtype=torch.int8, device=qs[0].device)
    s_all = torch.empty_like(scales.T.contiguous())
    dist.all_to_all_single(q_all, torch.cat([q.reshape(w, -1) for q in qs], dim=1),
                           group=group)
    dist.all_to_all_single(s_all, scales.T.contiguous(), group=group)
    mine = [_dequantized_mean(q.reshape(r.shape), s.reshape(w, *[1] * (r.dim() - 1)))
            for q, s, r in zip(q_all.split(sizes, dim=1), s_all.T, rows)]
    # Phase 2, the all-gather of the reduced chunks.
    amax2 = torch.stack([m.abs().amax() for m in mine])[:, None]
    model_group_max_(amax2, split, model)
    scales2 = _chunk_scales(amax2)[:, 0]                           # [n]
    q2 = [stochastic_round(u, m[None] / s.reshape([1] * (m.dim() + 1)))
          for m, s, u in zip(mine, scales2, u2s)]
    gq = torch.empty((w, sum(sizes)), dtype=torch.int8, device=q2[0].device)
    gs = torch.empty((w, len(leaves)), dtype=torch.float32, device=q2[0].device)
    # Gloo wants the input [1, N] of an output [W, N].
    dist.all_gather_into_tensor(gq, torch.cat([q.reshape(1, -1) for q in q2], dim=1),
                                group=group)
    dist.all_gather_into_tensor(gs, scales2[None].contiguous(), group=group)
    out = []
    for x, d, r, q, s in zip(leaves, dims, rows, gq.split(sizes, dim=1), gs.T):
        full = q.reshape(r.shape).to(torch.float32) * s.reshape(w, *[1] * (r.dim() - 1))
        full = full.reshape(-1, *r.shape[2:])[:x.shape[d]]
        out.append(torch.movedim(full, 0, d))
    return out


def compressed_pmean_nd(x: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, dim: int = 0,
                        group=None, model=None) -> torch.Tensor:
    """JAX's ``compressed_pmean_nd``: the mean over ``group``'s ranks of
    ``x``, int8 on both phases of the wire, chunked along ``dim`` without
    flattening. ``x`` is this rank's part of the leaf: its shard along a
    dim other than ``dim`` when ``model`` (a ``GroupRef``) splits it, the
    whole leaf otherwise. ``u1`` ``[W, c, *rest]`` and ``u2`` ``[1, c,
    *rest]`` are the two roundings' uniforms of this rank's part (``c =
    ceil(x.shape[dim] / W)``, ``rest`` the other dims in order). Float32
    in ``x``'s shape; ``x`` at one rank, the plain mean for a scalar."""
    if not allreduce_quantizes(group):
        return x
    if x.dim() == 0:
        return allreduce_mean_([x.clone()], group)[0]
    return _pmean_leaves([x], [dim], [model is not None], [u1], [u2], group, model)[0]


def compressed_pmean_tree_sharded(leaves: Sequence[torch.Tensor],
                                  u1s: Sequence[Optional[torch.Tensor]],
                                  u2s: Sequence[Optional[torch.Tensor]],
                                  specs: Optional[Sequence[Any]] = None, group=None,
                                  model=None) -> List[torch.Tensor]:
    """JAX's ``compressed_pmean_tree_sharded`` over a list of leaves (each
    a rank's part, in the JAX package's layout): :func:`compressed_pmean_nd`
    of each along :func:`wire_chunk_dim` of its shape and ``specs`` entry
    (the dims the second axis claims; None: none), with its uniforms
    (None for a leaf every dim of which is claimed). Such a leaf takes the
    plain float32 mean over ``group`` (one bucket for them all). A leaf
    with a claimed dim is split over ``model`` and its scales are the model
    group's. The inputs at one rank."""
    if not allreduce_quantizes(group):
        return list(leaves)
    specs = [None] * len(leaves) if specs is None else list(specs)
    if len(specs) != len(leaves):
        raise ValueError(f"specs has {len(specs)} entries for {len(leaves)} leaves")
    dims = [wire_chunk_dim(tuple(x.shape), sp) for x, sp in zip(leaves, specs)]
    plain = [i for i, d in enumerate(dims) if d is None or leaves[i].dim() == 0]
    out = list(leaves)
    if plain:
        means = allreduce_mean_([leaves[i].to(torch.float32).clone() for i in plain], group)
        for i, m in zip(plain, means):
            out[i] = m
    wire = [i for i in range(len(leaves)) if i not in set(plain)]
    if wire:
        split = [any(e is not None for e in (specs[i] or ())) for i in wire]
        got = _pmean_leaves([leaves[i] for i in wire], [dims[i] for i in wire], split,
                            [u1s[i] for i in wire], [u2s[i] for i in wire], group,
                            model if any(split) else None)
        for i, g in zip(wire, got):
            out[i] = g
    return out


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


def broadcast_from_first(values: Sequence[float], dtype: torch.dtype, group=None) -> List:
    """The group's first rank's ``values`` on every rank of ``group``, by
    one broadcast of ``dtype`` (the other ranks pass placeholders of the
    same length); ``values`` at one rank."""
    if world(group) == 1:
        return list(values)
    src = 0 if group is None else dist.get_global_rank(group, 0)

    def run(t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=src, group=group)
        return t

    return _host_collective(values, dtype, run, group)
