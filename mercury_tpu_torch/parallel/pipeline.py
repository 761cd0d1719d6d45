"""Pipeline parallelism: the GPipe schedule of
``mercury_tpu/parallel/pipeline.py`` over a pipe process group.

The Transformer's (or ViT's) encoder stack is split into ``S`` contiguous
stages, one a rank of the mesh's pipe group (the second axis of
``make_tp_mesh(1, S, "data", "pipe")``, ``parallel/mesh.py``): rank ``i``
holds blocks ``[i·L/S, (i+1)·L/S)`` of the ``L`` and drops the rest
(:func:`shard_stacked_blocks`), so a rank keeps ``L/S`` of the blocks'
weights, gradients and Adam moments. The embedding, positions, final norm
and head stay whole on every rank. :func:`make_pp_apply` runs a batch
through the stages in ``M`` microbatches as JAX's ``shard_map`` does:

- ``M + S − 1`` ticks; at each, every rank shifts its last output one rank
  on around the ring (``sequence.ring_shift``, one ``all_to_all_single``
  with splits: gloo takes CUDA tensors there), bubble ticks included, then
  applies its blocks to what it holds. Stage 0 holds microbatch
  ``min(t, M−1)`` in place of what it received (JAX's ``where``, so the
  received block stays in its graph), and the last stage keeps its output
  from tick ``S−1`` on as slot ``t−(S−1)``;
- the last stage's ``[M, mb, T, D]`` buffer reaches every rank by one
  all-reduce sum of it and the other ranks' zeros (JAX's masked ``psum``),
  and every rank runs the head on it;
- with experts, each rank sums its blocks' router losses over the ticks
  that carried a real microbatch (``0 ≤ t − i < M``), the sum is
  all-reduced over the pipe group and divided by ``M``.

Every rank records every tick's outputs in the graph that the buffer's
all-reduce ends, so each rank's backward walks the same chain and issues
the same collectives in the same order: the buffer's all-reduce, then the
``M + S − 2`` shifts back (tick 0 shifts zeros, with no gradient).

The gradient, as JAX's ``shard_map`` transposes it (pinned by its
``test_gradients_match_dense``: every gradient the unstaged model's at the
same ``M``). The logits, equal on every rank, pass through JAX's ``pmean``
over the pipe axis: the value unchanged, the gradient divided by S on each
rank (``_ReplicaMean``). The buffer's all-reduce has as its backward the
sum of the ranks' gradients, given to the last stage's buffer; the router
loss's sum passes its gradient unchanged to each rank's share. A block's
gradient is then whole on the rank that holds it and is never reduced; the
replicated parameters (``embed``, ``pos_embed``, ``norm``, ``head``) hold
S shares of theirs, one a rank (the embedding's on stage 0 alone), and
:func:`reduce_replicated_grads` sums them over the pipe group.

``remat=True`` recomputes each tick's stage in the backward
(``torch.utils.checkpoint``), as JAX's ``jax.checkpoint`` of the stage.

Two model axes (``parallel/mesh.make_pp_mesh``: pipe × ``inner``, the
inner axis innermost), as JAX composes them:

- **pipe × seq** (a model built with ``sp_axis``, the inner axis its
  name): ``x`` arrives as this rank's window of the sequence and each
  stage's blocks run the bound attention (ring, zigzag or Ulysses) over
  the seq group; the pooled mean is completed over it, so the logits are
  whole on every rank. The logits' ``pmean`` spans pipe × seq (the
  gradient ÷ S·N), and the router loss is also averaged over the seq group
  (``collectives.shard_mean``). A block's gradient then holds its seq
  rank's share of the tokens, and :func:`reduce_replicated_grads` sums it
  over the seq group, the replicated parameters' over both groups.
- **pipe × expert** (a model built with ``moe_experts`` and
  ``moe_ep_axis``): ``x`` arrives as this rank's slice of the batch and the
  logits come back for that slice; each stage's experts are split over the
  expert group (:func:`shard_stacked_blocks` cuts them) and dispatched by
  its all-to-all. The router loss is already the same on every rank of
  the group (the layer averages its statistics there), which JAX's
  ``pmean`` over the expert axis leaves as it is. Every gradient but the
  experts' holds the rank's batch share and is summed over the expert
  group; the replicated parameters' over the pipe group as well; the
  experts' is whole through the all-to-all's backward.

Within a stage the inner group's ranks run the same ticks, bubble ticks
included, so they issue the same collectives in the same order: the
experts' two all-to-alls and the router's all-reduce on bubble zeros too.
A model with both (pipe × expert × seq, JAX's ``x`` spec ``P(ep, sp)``) is
refused: :data:`PP_NOT_PORTED`.

JAX's ``SHARDING_CONTRACT`` and ``_stacked_block_specs`` (placements of a
stacked tree) have no torch role: a rank holds its stage's blocks, and its
experts of them, as modules.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from mercury_tpu_torch.models.moe import bind_expert_group, expert_leaf_names
from mercury_tpu_torch.parallel.collectives import (
    allreduce_sum,
    shard_mean,
    shard_sum,
    sum_grads_,
)
from mercury_tpu_torch.parallel.mesh import GroupRef, Mesh, inner_group, model_group
from mercury_tpu_torch.parallel.sequence import bind_sequence_group, ring_shift

PP_NOT_PORTED = ("pipeline parallelism over three axes (pipe × expert × seq: a model with "
                 "both sp_axis and moe_ep_axis) is not ported: ROADMAP.md, Queue 1 item 8d")


# ------------------------------------------------------------- the weights
def _stack(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees) if torch.is_tensor(first) else np.stack(trees)


def _pick(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def stack_block_params(params: Mapping[str, Any], num_layers: int) -> Tuple[dict, dict]:
    """``(stacked, rest)``: the blocks' leaves stacked along a new leading
    layer axis, and everything else. ``params`` is the port's state dict
    (``blocks.{i}.query.weight`` … → ``stacked["query.weight"]`` ``[L,
    ...]``) or the Flax ``params`` tree of numpy arrays (``block{i}`` →
    JAX's ``stacked``, leaf for leaf)."""
    if any(k.startswith("blocks.") for k in params):
        blocks = [{k[len(f"blocks.{i}."):]: v for k, v in params.items()
                   if k.startswith(f"blocks.{i}.")} for i in range(num_layers)]
        rest = {k: v for k, v in params.items() if not k.startswith("blocks.")}
    else:
        blocks = [params[f"block{i}"] for i in range(num_layers)]
        rest = {k: v for k, v in params.items() if not k.startswith("block")}
    return _stack(blocks), rest


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def unstack_block_params(stacked: Mapping[str, Any], rest: Mapping[str, Any]) -> dict:
    """The inverse of :func:`stack_block_params`: a state dict from
    tensors, a Flax tree from numpy arrays."""
    leaf = _first_leaf(stacked)
    out = dict(rest)
    for i in range(leaf.shape[0]):
        block = _pick(stacked, i)
        if torch.is_tensor(leaf):
            out.update({f"blocks.{i}.{k}": v for k, v in block.items()})
        else:
            out[f"block{i}"] = block
    return out


def staged_from_flax(stacked: Mapping[str, Any], rest: Mapping[str, Any], stage: int,
                     stages: int, expert: int = 0, experts: int = 1
                     ) -> Dict[str, torch.Tensor]:
    """Stage ``stage``'s state dict (of ``stages``) from the JAX package's
    ``(stacked, rest)`` numpy trees, as its ``create_pp_state`` makes them:
    unstacked, through ``params_from_flax``, then cut to the replicated
    entries and the stage's blocks numbered from 0 (what
    :func:`shard_stacked_blocks` leaves in ``model.blocks``), and on a pipe
    × expert mesh to the experts of rank ``expert`` of an expert group of
    ``experts`` (``models.convert.expert_shard``)."""
    from mercury_tpu_torch.models.convert import expert_shard, params_from_flax

    full = params_from_flax(unstack_block_params(stacked, rest), {})
    per = _per_stage(_first_leaf(stacked).shape[0], stages)
    out = {}
    for k, v in full.items():
        if not k.startswith("blocks."):
            out[k] = v
            continue
        _, i, leaf = k.split(".", 2)
        if stage * per <= int(i) < (stage + 1) * per:
            out[f"blocks.{int(i) - stage * per}.{leaf}"] = v
    return expert_shard(out, expert, experts)


def _per_stage(num_layers: int, stages: int) -> int:
    if num_layers % stages:
        raise ValueError(f"num_layers {num_layers} not divisible by pipe axis size {stages}")
    return num_layers // stages


def model_axes(model: nn.Module, mesh: Mesh) -> Tuple[Optional[str], Optional[str]]:
    """The model's sequence and expert axes ``(sp, ep)`` (None where it has
    none), each held to the mesh's axes with JAX's message; a model with
    both is refused (:data:`PP_NOT_PORTED`)."""
    sp = model.sp_axis
    ep = model.moe_ep_axis if model.moe_experts is not None else None
    if sp is not None and ep is not None:
        raise ValueError(f"{PP_NOT_PORTED} (sp_axis={sp!r}, moe_ep_axis={ep!r})")
    if sp is not None and sp not in mesh.axis_names:
        raise ValueError(f"model.sp_axis={sp!r} needs that axis in the mesh; "
                         f"mesh axes: {mesh.axis_names}")
    if ep is not None and ep not in mesh.axis_names:
        raise ValueError(f"model.moe_ep_axis={ep!r} needs that axis in the mesh; "
                         f"mesh axes: {mesh.axis_names}")
    inner = mesh.inner_axis
    if inner is not None and inner not in (sp, ep):
        raise ValueError(f"a {mesh.shape} mesh needs a model built with sp_axis or "
                         f"moe_ep_axis {inner!r}")
    return sp, ep


def shard_stacked_blocks(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut ``model`` to this rank's stage of the mesh's pipe group: keep
    blocks ``[stage·L/S, (stage+1)·L/S)`` in ``model.blocks`` and drop the
    others, whose memory goes with them (build the optimizer after). On a
    pipe × seq mesh the model takes the seq group
    (``bind_sequence_group``); on a pipe × expert mesh its experts take
    the expert group and are cut to this rank's ``E/W``
    (``bind_expert_group``). Returns the model."""
    sp, ep = model_axes(model, mesh)
    group = model_group(mesh)
    per = _per_stage(model.num_layers, group.size)
    if len(model.blocks) != model.num_layers:
        raise ValueError(f"the model holds {len(model.blocks)} of its {model.num_layers} "
                         "blocks: it is staged already")
    if ep is not None:
        # num_experts % W is refused before any block is dropped.
        bind_expert_group(model, inner_group(mesh))
    lo = group.rank * per
    model.blocks = nn.ModuleList(list(model.blocks)[lo:lo + per])
    if sp is not None:
        bind_sequence_group(model, inner_group(mesh))
    return model


def check_staged(model: nn.Module, mesh: Mesh) -> GroupRef:
    """The mesh's pipe group, once ``model`` is known to hold one stage's
    blocks of it (``L % S`` refused with JAX's message), its axes the
    mesh's (:func:`model_axes`)."""
    model_axes(model, mesh)
    group = model_group(mesh)
    per = _per_stage(model.num_layers, group.size)
    if len(model.blocks) != per:
        raise ValueError(f"the model holds {len(model.blocks)} blocks where a stage of "
                         f"{group.size} holds {per}: stage it with "
                         "shard_stacked_blocks(model, mesh)")
    return group


# ------------------------------------------------------------ collectives
class _FromLastStage(torch.autograd.Function):
    """The last stage's ``x`` on every rank: the all-reduce sum of ``x``
    there and zeros elsewhere; the backward sums the ranks' gradients into
    the last stage's ``x`` (zeros elsewhere)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: GroupRef) -> torch.Tensor:
        ctx.group, ctx.last = group, group.rank == group.size - 1
        return allreduce_sum(x if ctx.last else torch.zeros_like(x), group.group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        total = allreduce_sum(grad, ctx.group.group)
        return (total if ctx.last else torch.zeros_like(total)), None


class _ReplicaMean(torch.autograd.Function):
    """JAX's ``pmean`` over the pipe axis of a value every rank holds
    alike: the value itself, the gradient divided by the group's size."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size: int) -> torch.Tensor:
        ctx.size = size
        return x.clone()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad / ctx.size, None


def reduce_replicated_grads(model: nn.Module, mesh: Mesh) -> None:
    """Complete the gradients after the schedule's backward, as JAX's
    ``shard_map`` sums the cotangents of what an axis replicates: on a
    mesh with an inner axis, every gradient but the expert-parallel
    leaves' (``models.moe.expert_leaf_names``) summed over the inner group
    (a rank's share of its tokens); then the replicated parameters' (every
    parameter outside ``model.blocks``) over the pipe group, one
    all-reduce each (``collectives.sum_grads_``). A rank's missing
    gradient counts as zeros, and every rank ends with the sum set."""
    experts = expert_leaf_names(model)
    sum_grads_([p for name, p in model.named_parameters() if name not in experts],
               inner_group(mesh))
    sum_grads_([p for name, p in model.named_parameters() if not name.startswith("blocks.")],
               model_group(mesh))


# -------------------------------------------------------------- the schedule
def make_pp_apply(model: nn.Module, mesh: Mesh, num_microbatches: int, remat: bool = False,
                  with_aux: bool = False) -> Callable:
    """``apply(x) → logits`` (or ``(logits, aux)`` with ``with_aux``, the
    router loss summed over the stages and divided by ``M``) of ``model``,
    staged by :func:`shard_stacked_blocks` over the mesh's pipe group, in
    ``num_microbatches`` microbatches (module docstring). ``x`` ``[B, T,
    F]`` (or NCHW images under ``patch_size``) is the whole batch on every
    rank, ``B`` divisible by ``M``; on a pipe × seq mesh this rank's window
    of the tokens, on a pipe × expert mesh this rank's rows. The float32
    logits come back on every rank, for the rows it was given.
    Differentiable: after ``backward``, :func:`reduce_replicated_grads`
    completes the gradient. Refused as JAX refuses: a model axis the mesh
    lacks, experts without ``with_aux``, ``L % S``; and a model with both
    ``sp_axis`` and ``moe_ep_axis`` (:data:`PP_NOT_PORTED`)."""
    sp, _ = model_axes(model, mesh)
    if model.moe_experts is not None and not with_aux:
        raise ValueError("MoE blocks sow a router aux loss: call with with_aux=True "
                         "and add it to the training loss")
    group = check_staged(model, mesh)
    s, idx, m = group.size, group.rank, num_microbatches
    seq = inner_group(mesh) if sp is not None else GroupRef(None, 1, 0)
    # The logits are alike on the pipe ranks, and under sp on the seq ranks.
    replicas = s * seq.size

    def stage(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h, aux = model.run_blocks(h)
        return h, (h.new_zeros((), dtype=torch.float32) if aux is None else aux)

    def apply(x: torch.Tensor):
        h = model.embed_tokens(x)
        bsz, t, d = h.shape
        if bsz % m:
            raise ValueError(f"batch must divide into microbatches: {bsz} rows, {m} "
                             "microbatches")
        h_mb = h.reshape(m, bsz // m, t, d)
        first = torch.full((), idx == 0, device=h.device)
        prev = h.new_zeros(h_mb.shape[1:])
        outs, aux = [], h.new_zeros((), dtype=torch.float32)
        for tick in range(m + s - 1):
            x_in = torch.where(first, h_mb[min(tick, m - 1)], ring_shift(prev, group))
            if remat and torch.is_grad_enabled():
                prev, aux_t = checkpoint(stage, x_in, use_reentrant=False)
            else:
                prev, aux_t = stage(x_in)
            if tick >= s - 1:
                outs.append(prev)
            if 0 <= tick - idx < m:
                aux = aux + aux_t
        h_out = torch.stack(outs)
        if s > 1:
            h_out = _FromLastStage.apply(h_out, group)
        logits = model.pool_head(h_out.reshape(bsz, t, d))
        if replicas > 1:
            logits = _ReplicaMean.apply(logits, replicas)
        if not with_aux:
            return logits
        return logits, shard_mean(shard_sum(aux, group) / m, seq)

    return apply


__all__ = ["PP_NOT_PORTED", "check_staged", "make_pp_apply", "model_axes",
           "reduce_replicated_grads",
           "shard_stacked_blocks", "stack_block_params", "staged_from_flax",
           "unstack_block_params"]
