"""Attention of the port's Transformer: the dense scaled-dot-product
attention and the sequence-parallel attentions of
``mercury_tpu/parallel/sequence.py`` — ring, zigzag ring and Ulysses.

Plain PyTorch on purpose: the JAX package computes attention outside any
Pallas kernel, with ``jnp`` products and ``lax`` collectives.
``dense_attention`` keeps its rounding: both products in the input's dtype,
the scores in float32 scaled by ``1/sqrt(d)``, and the softmax
probabilities cast to ``v``'s dtype before the second product
(``scaled_dot_product_attention`` rounds a bf16 input otherwise).

The sequence-parallel functions work on this rank's block ``[B, L_loc, H,
D]`` of a sequence split over a group of W ranks, a
:class:`~mercury_tpu_torch.parallel.mesh.GroupRef` (the JAX functions'
``axis_name``): the global sequence is the blocks in the group's rank
order. No rank gathers the whole K/V or builds a global ``[L, L]`` tensor:

- :func:`ring_attention` folds the visiting K/V block into a float32
  online-softmax state ``(acc, row_max, row_sum)`` (:func:`_block_fold`),
  W hops, and passes K/V one rank on around the ring after each hop; the
  causal mask uses global positions;
- :func:`zigzag_ring_attention` is the balanced causal ring on the
  :func:`zigzag_order` layout (rank i holds chunks ``(i, 2W−1−i)``): a hop
  folds two ``[C, C]`` chunk pairs, chosen by whether the visitor's rank
  is lower or higher (each rank knows its rank, so a Python branch picks
  them where JAX selects with ``where``);
- :func:`ulysses_attention` reshards q/k/v from sequence shards to head
  shards with one all-to-all, runs :func:`dense_attention` over the whole
  sequence for ``H/W`` heads, and reshards back with a second.

The collectives are ``torch.autograd.Function``s, as Megatron's operators
in ``parallel/tensor.py``: the ring's shift (K and V stacked, one
collective a hop) has the shift the other way as its backward, and the
all-to-all is its own inverse, so its backward is the same all-to-all of
the gradient. The shift is one ``all_to_all_single`` whose splits send the
whole block to the next rank and take the previous rank's: gloo takes
CUDA tensors there, as NCCL does, where its ``batch_isend_irecv`` of CUDA
tensors fails (``chip_smoke.shift_forms`` tries both forms on each
backend).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mercury_tpu_torch.parallel.mesh import GroupRef

NEG_INF = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Scaled-dot-product attention; ``q``/``k``/``v`` ``[B, L, H, D]``,
    returns ``[B, L, H, D]`` in ``q``'s dtype."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    # sqrt is correctly rounded, so float32(sqrt(d)) is JAX's float32 sqrt.
    scores = scores / math.sqrt(d)
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        mask = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


# ------------------------------------------------------------- collectives
def _all_to_all(x: torch.Tensor, group: GroupRef, send: Optional[List[int]] = None,
                recv: Optional[List[int]] = None) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` over the group along dim 0 (equal
    chunks, or the row counts ``send``/``recv`` a rank)."""
    x = x.contiguous()
    shape = x.shape if recv is None else (sum(recv), *x.shape[1:])
    out = x.new_empty(shape)
    dist.all_to_all_single(out, x, output_split_sizes=recv, input_split_sizes=send,
                           group=group.group)
    return out


def _shifted(x: torch.Tensor, group: GroupRef, step: int) -> torch.Tensor:
    """The block of rank ``r − step`` on rank ``r`` (every rank sends its
    ``x`` to rank ``r + step``), around the ring."""
    w, r, n = group.size, group.rank, x.shape[0]
    send = [n if j == (r + step) % w else 0 for j in range(w)]
    recv = [n if j == (r - step) % w else 0 for j in range(w)]
    return _all_to_all(x, group, send, recv)


class RingShift(torch.autograd.Function):
    """K/V one rank on around the ring; the gradient one rank back."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: GroupRef) -> torch.Tensor:
        ctx.group = group
        return _shifted(x, group, 1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _shifted(grad, ctx.group, -1), None


class AllToAll(torch.autograd.Function):
    """An all-to-all of equal chunks along dim 0: rank r's chunk j goes to
    rank j as its chunk r. Its own inverse, so the backward is the same
    all-to-all of the gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: GroupRef) -> torch.Tensor:
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _all_to_all(grad, ctx.group), None


def ring_shift(x: torch.Tensor, group: GroupRef) -> torch.Tensor:
    """:class:`RingShift` of ``x``; ``x`` itself in a group of one."""
    return x if group.size == 1 else RingShift.apply(x, group)


def all_to_all(x: torch.Tensor, group: GroupRef) -> torch.Tensor:
    """:class:`AllToAll` of ``x``; ``x`` itself in a group of one."""
    return x if group.size == 1 else AllToAll.apply(x, group)


# ---------------------------------------------------------------- the ring
def _init_state(q: torch.Tensor) -> State:
    b, l, h, d = q.shape
    return (q.new_zeros((b, l, h, d), dtype=torch.float32),
            q.new_full((b, h, l), NEG_INF, dtype=torch.float32),
            q.new_zeros((b, h, l), dtype=torch.float32))


def _block_fold(state: State, q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                mask: Optional[torch.Tensor]) -> State:
    """Fold one visiting K/V block into the online-softmax state.

    ``q``: ``[B, Lq, H, D]``; ``k_blk``/``v_blk``: ``[B, Lk, H, D]``;
    ``mask``: ``[Lq, Lk]`` bool or None. The state is float32: ``acc``
    ``[B, Lq, H, D]``, ``row_max``/``row_sum`` ``[B, H, Lq]``. Both
    products run in the input's dtype, as in :func:`dense_attention`."""
    acc, row_max, row_sum = state
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    new_max = torch.maximum(row_max, scores.amax(dim=-1))       # [B, H, Lq]
    # Rescale the running accumulator to the new max, then add this block.
    correction = torch.exp(row_max - new_max)
    p = torch.exp(scores - new_max[..., None])                   # [B, H, Lq, Lk]
    blk_out = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk).float()
    acc = acc * correction.transpose(1, 2)[..., None] + blk_out
    row_sum = row_sum * correction + p.sum(dim=-1)
    return acc, new_max, row_sum


def _finish(state: State, dtype: torch.dtype) -> torch.Tensor:
    acc, _, row_sum = state
    return (acc / row_sum.transpose(1, 2)[..., None]).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: GroupRef,
                   causal: bool = False) -> torch.Tensor:
    """Ring attention over sequence shards: this rank's output block
    ``[B, L_loc, H, D]``, matching :func:`dense_attention` on the gathered
    sequence. Each of the W hops folds the visiting K/V block, then K/V
    move one rank on (:func:`ring_shift`, both in one collective). With
    ``causal``, blocks wholly in the future are masked on global
    positions; their products still run (the ring is hop-synchronous) —
    :func:`zigzag_ring_attention` halves that work."""
    w, my = group.size, group.rank
    l_loc = q.shape[1]
    state = _init_state(q)
    pos = torch.arange(l_loc, device=q.device)
    kv = torch.stack((k, v))
    for hop in range(w):
        # After `hop` shifts the resident block came from rank my − hop.
        src = (my - hop) % w
        mask = None
        if causal:
            mask = (my * l_loc + pos)[:, None] >= (src * l_loc + pos)[None, :]
        state = _block_fold(state, q, kv[0], kv[1], mask)
        if hop + 1 < w:
            kv = ring_shift(kv, group)
    return _finish(state, q.dtype)


def zigzag_order(length: int, w: int) -> np.ndarray:
    """Global sequence positions in zigzag-shard order: the sequence cut
    into ``2W`` chunks, rank ``i`` holding chunks ``(i, 2W−1−i)`` — the
    balanced causal layout of striped/zigzag ring attention (Brandon et
    al., arXiv:2311.09431). ``x[perm]`` is the zigzag layout (shard ``i`` =
    rows ``[i·L/W, (i+1)·L/W)`` of the permuted array)."""
    if length % (2 * w) != 0:
        raise ValueError(
            f"zigzag layout needs sequence length ({length}) divisible by "
            f"2 x axis size ({2 * w})"
        )
    c = length // (2 * w)
    chunks = np.arange(length).reshape(2 * w, c)
    order = [chunks[i] for pair in range(w) for i in (pair, 2 * w - 1 - pair)]
    return np.concatenate(order)


def zigzag_inverse(length: int, w: int) -> np.ndarray:
    """Inverse permutation of :func:`zigzag_order`: ``out[zigzag_inverse]``
    restores sequence order from the zigzag layout."""
    perm = zigzag_order(length, w)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(length)
    return inv


def _halves(state: State, c: int) -> Tuple[State, State]:
    acc, row_max, row_sum = state
    return ((acc[:, :c], row_max[..., :c], row_sum[..., :c]),
            (acc[:, c:], row_max[..., c:], row_sum[..., c:]))


def zigzag_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          group: GroupRef, causal: bool = True) -> torch.Tensor:
    """Causal ring attention on the :func:`zigzag_order` layout (this
    rank's block is global chunks ``(i, 2W−1−i)``, the low chunk first).

    The self hop is the local block under the lower-triangular mask. On a
    hop from a LOWER rank both resident chunks attend the visitor's low
    chunk (its high chunk lies in their future); from a HIGHER rank only
    the resident high chunk attends, to both of the visitor's chunks, and
    is folded twice in sequence, the second fold seeing the first's state
    as in JAX. Either way two ``[C, C]`` chunk pairs a hop, half the plain
    ring's products. ``causal=False`` is :func:`ring_attention` (the
    layout only relabels positions)."""
    w, my = group.size, group.rank
    l_loc = q.shape[1]
    if l_loc % 2 != 0:
        raise ValueError(
            f"zigzag ring attention needs an even local length, got {l_loc}"
        )
    if not causal:
        return ring_attention(q, k, v, group, causal=False)
    c = l_loc // 2
    q_lo, q_hi = q[:, :c], q[:, c:]
    pos = torch.arange(l_loc, device=q.device)
    lo, hi = _halves(_block_fold(_init_state(q), q, k, v, pos[:, None] >= pos[None, :]), c)
    kv = torch.stack((k, v))
    for hop in range(1, w):
        kv = ring_shift(kv, group)
        src = (my - hop) % w
        k_lo, k_hi = kv[0, :, :c], kv[0, :, c:]
        v_lo, v_hi = kv[1, :, :c], kv[1, :, c:]
        if src < my:
            lo = _block_fold(lo, q_lo, k_lo, v_lo, None)
            hi = _block_fold(hi, q_hi, k_lo, v_lo, None)
        else:
            hi = _block_fold(hi, q_hi, k_lo, v_lo, None)
            hi = _block_fold(hi, q_hi, k_hi, v_hi, None)
    state = tuple(torch.cat(pair, dim=1 if i == 0 else -1)
                  for i, pair in enumerate(zip(lo, hi)))
    return _finish(state, q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: GroupRef,
                      causal: bool = False, axis_name: str = "seq") -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism: one
    all-to-all of the stacked q/k/v from ``[B, L/W, H, D]`` sequence shards
    to ``[B, L, H/W, D]`` head shards, :func:`dense_attention` over the
    whole sequence, and one all-to-all back. Needs ``H % W == 0``;
    ``axis_name`` names the group in that refusal."""
    w = group.size
    b, l_loc, h, d = q.shape
    if h % w != 0:
        raise ValueError(
            f"ulysses attention needs num_heads ({h}) divisible by the "
            f"'{axis_name}' axis size ({w}); use ring attention otherwise"
        )
    hw = h // w
    # [3, B, L/W, W, H/W, D] → chunk j (heads j·H/W …) first, for rank j.
    x = torch.stack((q, k, v)).view(3, b, l_loc, w, hw, d).permute(3, 0, 1, 2, 4, 5)
    x = all_to_all(x, group)                          # [W(src), 3, B, L/W, H/W, D]
    qg, kg, vg = x.permute(1, 2, 0, 3, 4, 5).reshape(3, b, w * l_loc, hw, d)
    out = dense_attention(qg, kg, vg, causal=causal)  # [B, L, H/W, D]
    out = out.view(b, w, l_loc, hw, d).permute(1, 0, 2, 3, 4)
    out = all_to_all(out, group)                      # [W(heads), B, L/W, H/W, D]
    return out.permute(1, 2, 0, 3, 4).reshape(b, l_loc, h, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
              sp_axis: Optional[str] = None, sp_impl: str = "ring",
              group: Optional[GroupRef] = None) -> torch.Tensor:
    """The JAX dispatcher: :func:`dense_attention` without ``sp_axis``;
    with it, the sequence-parallel attention ``sp_impl`` names over
    ``group``, the sequence's group (``"zigzag"`` wants the
    :func:`zigzag_order` layout; ``"ulysses"`` ``H % W == 0``)."""
    if sp_axis is None:
        return dense_attention(q, k, v, causal=causal)
    if group is None:
        raise ValueError(f"sp_axis={sp_axis!r} needs its sequence group bound "
                         "(parallel.sequence.bind_sequence_group)")
    if sp_impl == "ring":
        return ring_attention(q, k, v, group, causal=causal)
    if sp_impl == "zigzag":
        return zigzag_ring_attention(q, k, v, group, causal=causal)
    if sp_impl == "ulysses":
        return ulysses_attention(q, k, v, group, causal=causal, axis_name=sp_axis)
    raise ValueError(
        f"unknown sp_impl {sp_impl!r} (expected 'ring', 'zigzag', or "
        "'ulysses')"
    )


def bind_sequence_group(model: torch.nn.Module, group: GroupRef) -> torch.nn.Module:
    """Hand a Transformer built with ``sp_axis`` its sequence group, as
    ``parallel.tensor.shard_model_tp`` hands a model its model group: the
    model (its positions and mean pool) and each block (its attention)
    hold it as ``sp``. Returns the model."""
    if getattr(model, "sp_axis", None) is None:
        raise ValueError("bind_sequence_group needs a model built with sp_axis")
    model.sp = group
    for block in model.blocks:
        block.sp = group
    return model


__all__ = ["NEG_INF", "AllToAll", "RingShift", "all_to_all", "attention",
           "bind_sequence_group", "dense_attention", "ring_attention", "ring_shift",
           "ulysses_attention", "zigzag_inverse", "zigzag_order", "zigzag_ring_attention"]
