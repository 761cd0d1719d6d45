"""The device mesh of the port: process groups over ``torch.distributed`` —
the counterpart of ``make_mesh`` and ``make_tp_mesh`` in
``mercury_tpu/parallel/mesh.py``.

One process runs each rank. A data-only mesh is the default process group
itself: ``world_size`` ranks, each a data worker. A mesh with a second axis
(``tensor_parallel=T`` or ``fsdp_parallel=F``, of size ``N``) takes
``world_size × N`` ranks with the second axis innermost, as the JAX mesh
places the model axis: global rank ``r`` is data worker ``r // N`` and
shard ``r % N`` of its model. Two groups hold each rank:

- the **data group**, the ranks with the same ``r % N``: every collective
  of the data-parallel step (synced BN, the pool mean, the gradient
  bucket, the running statistics, the metrics, the supervisor's
  agreement) runs over it, between the replicas of one shard;
- the **model group**, the ranks with the same ``r // N``: the workers'
  own ranks, which carry only what the sharding needs (Megatron's two
  all-reduces a block, or FSDP's gathers and reduce-scatters).

Every rank creates every group, in the same order (``dist.new_group``
needs that). A rank of a model group is the same data worker as its
peers: the same shard row, sampler row and draws.

A pipeline's mesh may carry a second model axis (:func:`make_pp_mesh`,
JAX's ``Mesh(devices.reshape(S, N), ("pipe", inner))``): one data worker,
``S × N`` ranks, the inner axis (``"seq"`` or ``"expert"``) innermost, so
global rank ``r`` is stage ``r // N`` and rank ``r % N`` of its inner
group. The pipe group (the ranks with the same ``r % N``) is the mesh's
``model``, as on the one-axis pipe mesh, and the inner group its
``inner``.

:class:`ParamSharding` is a model's layout over its model group (which
parameter is split along which dimension), and the functions below slice a
full state dict into a rank's shards and gather the shards back, for
``params_from_flax``, the checkpoints and the tests.

The JAX module's other helpers have no torch role: the scorer's reserved
card is ``distributed.reserve_scorer_device``; ``host_cpu_mesh`` (virtual
CPU devices) is gloo ranks on the CPU here; ``data_sharding`` and
``replicate`` are each process holding its own rank's tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mercury_tpu_torch.parallel.collectives import rank as group_rank
from mercury_tpu_torch.parallel.collectives import world


class GroupRef:
    """A process group with this rank's place in it, held by reference:
    a model that holds one deep-copies (``MercuryState.clone``) without
    copying the group."""

    def __init__(self, group: Any, size: int, rank: int) -> None:
        self.group, self.size, self.rank = group, size, rank

    def __deepcopy__(self, memo) -> "GroupRef":
        return self

    def __repr__(self) -> str:
        return f"GroupRef(size={self.size}, rank={self.rank})"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``data × second`` mesh.

    ``axis_names`` is ``(data,)``, ``(data, second)`` or, on a pipeline's
    mesh with a second model axis, ``(data, pipe, inner)``; ``shape`` maps
    each name to its size. ``data_group`` is None on a data-only mesh (the
    default group: every rank a worker) and on :func:`make_pp_mesh`'s (one
    worker); ``model`` is the second axis's group, None without one;
    ``inner`` the third axis's, None without one."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    data_rank: int
    model_rank: int
    data_group: Any = None
    model: Optional[GroupRef] = None
    inner: Optional[GroupRef] = None

    @property
    def world_size(self) -> int:
        """The data workers."""
        return self.shape[self.axis_names[0]]

    @property
    def second(self) -> int:
        """The second axis's size (1 on a data-only mesh)."""
        return self.shape[self.axis_names[1]] if len(self.axis_names) > 1 else 1

    @property
    def inner_axis(self) -> Optional[str]:
        """The third axis's name, None without one."""
        return self.axis_names[2] if len(self.axis_names) > 2 else None

    @property
    def rank(self) -> int:
        """The global rank."""
        n, i = (1, 0) if self.inner is None else (self.inner.size, self.inner.rank)
        return (self.data_rank * self.second + self.model_rank) * n + i

    @property
    def leads(self) -> bool:
        """The first rank of its model group: the one that writes its
        worker's logs (global rank 0 writes the run's)."""
        return self.model_rank == 0


def model_group(mesh: Mesh) -> GroupRef:
    """The mesh's second axis's group, or a group of one on a data-only
    mesh."""
    return mesh.model if mesh.model is not None else GroupRef(None, 1, 0)


def inner_group(mesh: Mesh) -> GroupRef:
    """The mesh's third axis's group, or a group of one without one."""
    return mesh.inner if mesh.inner is not None else GroupRef(None, 1, 0)


def make_mesh(world_size: int, axis_name: str = "data") -> Mesh:
    """The data-only mesh: every rank a worker, the default group."""
    r = group_rank()
    return Mesh((axis_name,), {axis_name: world_size}, data_rank=r, model_rank=0)


def make_tp_mesh(world_size: int, n: int, data_axis: str = "data",
                 model_axis: str = "model") -> Mesh:
    """The ``world_size × n`` mesh, the second axis innermost; a data-only
    mesh at ``n=1``. Needs a process group of ``world_size·n`` ranks, and
    every rank must call it (each creates every group)."""
    if n == 1:
        return make_mesh(world_size, data_axis)
    need = world_size * n
    if world() != need:
        raise ValueError(f"a {world_size}×{n} mesh needs {need} ranks, "
                         f"the process group has {world()}")
    r = group_rank()
    data_rank, model_rank = divmod(r, n)
    data_group = model_group = None
    for m in range(n):
        g = dist.new_group([w * n + m for w in range(world_size)])
        if m == model_rank:
            data_group = g
    for w in range(world_size):
        g = dist.new_group([w * n + m for m in range(n)])
        if w == data_rank:
            model_group = g
    return Mesh((data_axis, model_axis), {data_axis: world_size, model_axis: n},
                data_rank=data_rank, model_rank=model_rank, data_group=data_group,
                model=GroupRef(model_group, n, model_rank))


def make_pp_mesh(stages: int, n: int, inner_axis: str) -> Mesh:
    """One worker's ``stages × n`` mesh with two model axes: ``"pipe"``
    and ``inner_axis`` (``"seq"`` or ``"expert"``), innermost. Needs a
    process group of ``stages·n`` ranks, and every rank must call it."""
    need = stages * n
    if world() != need:
        raise ValueError(f"a {stages}×{n} mesh needs {need} ranks, "
                         f"the process group has {world()}")
    stage, i = divmod(group_rank(), n)
    pipe = inner = None
    for m in range(n):
        g = dist.new_group([s * n + m for s in range(stages)])
        if m == i:
            pipe = g
    for s in range(stages):
        g = dist.new_group([s * n + m for m in range(n)])
        if s == stage:
            inner = g
    return Mesh(("data", "pipe", inner_axis), {"data": 1, "pipe": stages, inner_axis: n},
                data_rank=0, model_rank=stage, model=GroupRef(pipe, stages, stage),
                inner=GroupRef(inner, n, i))


@dataclasses.dataclass
class ParamSharding:
    """A model's parameters over its model group: ``dims`` maps a
    parameter's name to the torch dimension it is split along (in ``size``
    equal chunks, chunk ``rank`` held here); a name it lacks is
    replicated."""

    dims: Dict[str, int]
    group: GroupRef

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def rank(self) -> int:
        return self.group.rank


def sharding_of(model: torch.nn.Module) -> Optional[ParamSharding]:
    """The model's :class:`ParamSharding`, None for a replicated model."""
    return getattr(model, "param_sharding", None)


def shard_of(full: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Chunk ``rank`` of ``size`` of ``full`` along ``dim``, a copy."""
    return full.chunk(size, dim)[rank].clone()


def gather_dim(shard: torch.Tensor, dim: int, group: GroupRef) -> torch.Tensor:
    """The group's shards of a tensor concatenated along ``dim`` (one
    ``all_gather_into_tensor``; not differentiable)."""
    if group.size == 1:
        return shard
    part = shard.detach().contiguous()
    out = part.new_empty((group.size * part.numel(),))
    dist.all_gather_into_tensor(out, part.reshape(-1), group=group.group)
    return torch.cat(out.view(group.size, *part.shape).unbind(0), dim=dim)


def local_state_dict(model: torch.nn.Module, full: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``full`` (a state dict of the unsharded model) cut to this rank's
    shards of ``model``'s layout."""
    sh = sharding_of(model)
    if sh is None:
        return dict(full)
    return {k: shard_of(v, sh.dims[k], sh.rank, sh.size) if k in sh.dims else v
            for k, v in full.items()}


def load_full_state_dict(model: torch.nn.Module, full: Dict[str, torch.Tensor]) -> None:
    """Load an unsharded state dict into a (possibly sharded) model: each
    rank takes its slices."""
    model.load_state_dict(local_state_dict(model, full))


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The unsharded model's state dict, gathered over the model group (a
    collective of every rank of the group), on each parameter's device."""
    sd = model.state_dict()
    sh = sharding_of(model)
    if sh is None:
        return sd
    return {k: gather_dim(v, sh.dims[k], sh.group) if k in sh.dims else v
            for k, v in sd.items()}


def param_dims(model: torch.nn.Module) -> List[Optional[int]]:
    """The split dimension of each parameter in ``model.parameters()``
    order (None: replicated), the order of the optimizer's state."""
    sh = sharding_of(model)
    return [None if sh is None else sh.dims.get(name)
            for name, _ in model.named_parameters()]


def full_optimizer_state(model: torch.nn.Module, state: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer's ``state_dict()`` with every per-parameter tensor of
    a parameter's shape gathered to the unsharded shape (a collective of
    the model group); counters as they are."""
    sh = sharding_of(model)
    if sh is None:
        return state
    dims = param_dims(model)
    params = list(model.parameters())
    out = {}
    for i, st in state["state"].items():
        d, p = dims[i], params[i]
        out[i] = {k: gather_dim(v, d, sh.group)
                  if d is not None and torch.is_tensor(v) and v.shape == p.shape else v
                  for k, v in st.items()}
    return {"state": out, "param_groups": state["param_groups"]}


def local_optimizer_state(model: torch.nn.Module, state: Dict[str, Any]) -> Dict[str, Any]:
    """An unsharded optimizer ``state_dict()`` cut to this rank's shards."""
    sh = sharding_of(model)
    if sh is None:
        return state
    dims = param_dims(model)
    shapes = full_shapes(model)
    whole = [shapes[name] for name, _ in model.named_parameters()]
    out = {}
    for i, st in state["state"].items():
        d = dims[i]
        out[i] = {k: shard_of(v, d, sh.rank, sh.size)
                  if d is not None and torch.is_tensor(v) and v.shape == whole[i] else v
                  for k, v in st.items()}
    return {"state": out, "param_groups": state["param_groups"]}


def local_like_params(model: torch.nn.Module, tensors: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """Unsharded tensors of the parameters' shapes, one a parameter in
    ``model.parameters()`` order (the accumulator), cut to this rank's."""
    sh = sharding_of(model)
    if sh is None:
        return list(tensors)
    return [t if d is None else shard_of(t, d, sh.rank, sh.size)
            for t, d in zip(tensors, param_dims(model))]


def full_like_params(model: torch.nn.Module, tensors: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """The inverse of :func:`local_like_params`: gathered over the model
    group (a collective)."""
    sh = sharding_of(model)
    if sh is None:
        return list(tensors)
    return [t if d is None else gather_dim(t, d, sh.group)
            for t, d in zip(tensors, param_dims(model))]


def full_shapes(model: torch.nn.Module) -> Dict[str, torch.Size]:
    """The unsharded shape of every entry of ``model.state_dict()`` (a
    parameter's split dimension times the group's size), by name."""
    sh = sharding_of(model)
    out = {}
    for name, t in model.state_dict().items():
        shape = list(t.shape)
        if sh is not None and name in sh.dims:
            shape[sh.dims[name]] *= sh.size
        out[name] = torch.Size(shape)
    return out


__all__ = ["GroupRef", "Mesh", "ParamSharding", "inner_group", "make_mesh", "make_pp_mesh",
           "make_tp_mesh", "model_group",
           "sharding_of", "shard_of", "gather_dim", "local_state_dict", "load_full_state_dict",
           "full_state_dict", "full_shapes", "param_dims", "full_optimizer_state",
           "local_optimizer_state", "local_like_params", "full_like_params"]
