"""Training state of the port: the model, its optimizer and learning-rate
schedule, and the Mercury sampler state (EMA, presampling stream, score
table, random generator) — the PyTorch counterpart of
``mercury_tpu/train/state.py``. A process holds one worker's state: the
model and optimizer are replicas, the sampler state is the rank's own.

The optimizers follow optax's: ``optax.adam``/``adamw``/``sgd(momentum=0.9)``
under ``cosine_decay_schedule(lr, updates)`` (optionally after a linear
warmup). optax's update count starts at 0, so the first update uses the
full ``lr``; here the step sets the learning rate of update ``k`` to
``lr_schedule(k)`` before ``optimizer.step()``.

With ``grad_accum_steps=A > 1`` the state also carries optax.MultiSteps'
accumulator: each step (a microstep) folds its gradient into ``accum``, and
every A-th applies the update, so ``updates = ceil(total_steps / A)``.

With the score table and ``telemetry`` the state also carries the
selection-count ledger ``sel_counts``: how often each slot of this rank's
shard has been trained on.

Under ``data_placement="host_stream"`` it carries the ring of selections in
flight, :class:`PendingSelection`: the slots and weights of steps
t … t+depth−1, drawn ``depth`` steps ahead, and those steps' random draws.

With ``zero_sharding`` (ZeRO-1) the optimizer holds one float32 tensor,
this rank's chunk of the flattened parameters in the JAX package's order,
and its state (and the accumulator) are that chunk's. ZeRO's step and the
int8 wire read the flat order, :class:`FlatLayout`, which
:func:`flat_layout` builds on first use and keeps on the state.

Under ``tensor_parallel`` or ``fsdp_parallel`` the model holds this
rank's shards (``parallel/tensor.py``, ``parallel/fsdp.py``), so the
optimizer steps over the local shards and Adam's moments are shards too;
``mesh`` is the rank's :class:`~mercury_tpu_torch.parallel.mesh.Mesh`,
which the checkpoints read for the data rank and group.

The pool sampler's step modes carry their own: ``pipelined_scoring`` the
batch selected for the next step (:class:`PendingBatch`),
``score_refresh_every > 1`` the scored pool it redraws from
(:class:`CachedPool`), and ``sampler="groupwise"`` the shard's importance
and group tags (``sampling/groupwise.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mercury_tpu_torch.data.pipeline import ShardStream, init_shard_streams
from mercury_tpu_torch.models.convert import flax_leaves, jax_flat_order
from mercury_tpu_torch.parallel import collectives
from mercury_tpu_torch.parallel.mesh import sharding_of
from mercury_tpu_torch.sampling.groupwise import GroupwiseState, init_groupwise
from mercury_tpu_torch.sampling.importance import EMAState, init_ema
from mercury_tpu_torch.sampling.scoretable import ScoreTableState, init_score_table
from mercury_tpu_torch.utils.tree import zero_chunk_size

Schedule = Callable[[int], float]


class Augment(NamedTuple):
    """The random numbers of one ingest of ``n`` images."""

    crop: torch.Tensor                    # [n, 2] int32 offsets in [0, 2·pad] (iid: [0, 3])
    flip: torch.Tensor                    # [n] bool horizontal flips
    theta: Optional[torch.Tensor] = None  # [n] float32 radians (iid only)
    scale: Optional[torch.Tensor] = None  # [n] float32 (iid only)
    cut: Optional[torch.Tensor] = None    # [n, 2] int32 cutout centres (noniid cutout only)


class Draws(NamedTuple):
    """The random numbers of one step. ``aug`` augments the rows scored
    first — the pool, or the scoretable's refresh window (the JAX step's
    ``k_aug``); ``aug2`` the drawn train batch of the steps that gather
    its rows anew: scoretable, groupwise and the cached-pool cadence
    (``k_aug2``). ``boot`` is the boot pool's own perm, aug and uniforms,
    drawn at step 0 of ``pipelined_scoring`` only (``k_boot_stream``,
    ``k_boot_aug``, ``k_boot_sel``). The gradient's quantizers read the
    last three, drawn only when their option is on: ``grad_uniforms`` one
    uniform a gradient element under ``grad_compression="stochastic"`` (the
    JAX step's ``split(fold_in(rng, 0x71), n_leaves)``), ``wire_u1`` and
    ``wire_u2`` the int8 wire's two roundings (``split(fold_in(rng,
    0x72))``). Under ``tensor_parallel`` or ``fsdp_parallel`` they are the
    whole leaves' (the same on every rank of a model group, each rank
    taking its shard's part), and the int8 wire's are ``wire_leaves``, a
    pair a leaf (JAX's ``split(fold_in(rng, 0x72), n_leaves)``, each key
    split in two)."""

    perm: Optional[torch.Tensor]  # [L] reshuffle permutation; read only if the stream wraps
    aug: Optional[Augment]        # P or R images (None on a cadence step that reuses its pool)
    uniforms: Optional[torch.Tensor]  # [1, B] float32 U(0,1) of the draw (IS only)
    aug2: Optional[Augment] = None    # B images (scoretable, groupwise, cadence)
    boot: Optional["Draws"] = None    # pipelined step 0: the boot pool's draws
    # a float32 tensor of each parameter's shape, in model.parameters() order
    grad_uniforms: Optional[Tuple[torch.Tensor, ...]] = None
    wire_u1: Optional[torch.Tensor] = None  # [W, chunk] the gradient rows, JAX order
    wire_u2: Optional[torch.Tensor] = None  # [chunk] the gathered chunk
    # Under a second mesh axis, the per-leaf int8 wire's: a (u1, u2) pair a
    # parameter in model.parameters() order, the whole leaf's (LeafWire's
    # shapes), or None for a leaf that takes the plain mean
    wire_leaves: Optional[Tuple[Optional[Tuple[torch.Tensor, torch.Tensor]], ...]] = None


class FlatLayout(NamedTuple):
    """The parameters as the JAX package's flat vector (``ravel_pytree``
    order, ``models/convert.jax_flat_order``), cut into ZeRO's ``[W,
    chunk]``: rank ``r`` owns elements ``[r·chunk, (r+1)·chunk)``."""

    order: torch.Tensor    # [n] int64: jax_vec = port_vec[order]
    inverse: torch.Tensor  # [n] int64: port_vec = jax_vec[inverse]
    world: int
    rank: int

    @property
    def n(self) -> int:
        return self.order.numel()

    @property
    def chunk(self) -> int:
        return zero_chunk_size(self.n, self.world)


class LeafWire(NamedTuple):
    """One parameter on the per-leaf int8 wire of a second mesh axis
    (``parallel/collectives.compressed_pmean_tree_sharded``), in the JAX
    package's layout (Flax's): where the wire cuts it and which part of
    the whole leaf's uniforms this rank's shard takes."""

    path: Tuple[str, ...]             # its Flax path (the JAX leaf order)
    axes: Tuple[int, ...]             # Flax dim i is torch dim axes[i]
    shape: Tuple[int, ...]            # the whole leaf's Flax shape
    spec: Tuple[Optional[str], ...]   # the second axis's name at its split dim
    dim: Optional[int]                # the wire's chunk dim; None: the plain mean
    split: Optional[int]              # the Flax dim split over the model group

    def uniform_shapes(self, w: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """The two roundings' uniforms of the whole leaf at ``w`` data
        ranks: ``[w, c, *rest]`` and ``[1, c, *rest]``."""
        rest = tuple(n for i, n in enumerate(self.shape) if i != self.dim)
        c = -(-self.shape[self.dim] // w)
        return (w, c, *rest), (1, c, *rest)

    def local(self, u: torch.Tensor, rank: int, size: int) -> torch.Tensor:
        """This shard's part of the whole leaf's uniforms ``u``."""
        if self.split is None:
            return u
        at = 2 + (self.split if self.split < self.dim else self.split - 1)
        return u.chunk(size, at)[rank]


class PendingBatch(NamedTuple):
    """The batch selected for the next step under ``pipelined_scoring``
    (the JAX package's ``PendingBatch``): the very images that were scored,
    augmented and normalized, not a re-gather by slot."""

    images: torch.Tensor        # [B, H, W, C] float32 after augmentation
    labels: torch.Tensor        # [B] int32
    scaled_probs: torch.Tensor  # [B] float32 p·P of the draw


class CachedPool(NamedTuple):
    """The scored pool that ``score_refresh_every = K > 1`` redraws from
    on the K−1 steps after its refresh (the JAX package's ``CachedPool``)."""

    slots: torch.Tensor      # [P] int64 shard slots
    probs: torch.Tensor      # [P] float32 distribution of the refresh
    pool_loss: torch.Tensor  # [] float32 train/pool_loss of the refresh


class PendingSelection(NamedTuple):
    """The ring of selections in flight under ``host_stream`` (the JAX
    package's ``PendingSelection``): step t trains on ``slots[0]``, whose
    rows the prefetch pipeline gathered, and appends the selection it draws
    for step t+depth. In place of the JAX ring's key of step t+depth it
    carries ``draws``, the whole :class:`Draws` of steps t … t+depth−1,
    drawn in step order from the one generator, so the generator's sequence
    is the replicated run's."""

    slots: torch.Tensor         # [depth, S] int64 shard slots (scoretable: window ‖ batch)
    scaled_probs: torch.Tensor  # [depth, B] float32 p·L at draw time (ones: pool, uniform)
    draws: Tuple[Draws, ...]    # depth Draws of steps t … t+depth−1


def _map_tensors(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` applied to every tensor of nested named tuples and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def clone_pending(pending):
    """A copy of the tensors of a ring, a batch, a pool or a groupwise
    state (``None`` stays ``None``)."""
    return None if pending is None else _map_tensors(torch.clone, pending)


def _plain(tree):
    """Named tuples → dicts (with a ``None`` kept) of host copies, for
    ``torch.load``'s ``weights_only`` reader."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (tuple, list)):
        return [_plain(v) for v in tree]
    return tree.detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree


def pending_to_host(pending) -> Dict[str, Any]:
    """The ring (or a mode's carried state) as plain dicts and lists of
    host tensors."""
    return _plain(pending)


def carried_from_host(cls, saved: Optional[Dict[str, Any]], device):
    """A :class:`PendingBatch`, :class:`CachedPool` or
    :class:`GroupwiseState` from :func:`pending_to_host`'s dict, on
    ``device``."""
    if saved is None:
        return None
    return cls(**{k: v.to(device) if isinstance(v, torch.Tensor) else v
                  for k, v in saved.items()})


def pending_from_host(saved: Dict[str, Any], device) -> PendingSelection:
    """The inverse of :func:`pending_to_host`, on ``device``."""
    def put(t):
        return None if t is None else t.to(device)

    def augment(d):
        return None if d is None else Augment(**{k: put(v) for k, v in d.items()})

    def each(ts):
        return None if ts is None else tuple(put(t) for t in ts)

    draws = tuple(Draws(perm=put(d["perm"]), aug=augment(d["aug"]),
                        uniforms=put(d["uniforms"]), aug2=augment(d["aug2"]),
                        grad_uniforms=each(d.get("grad_uniforms")),
                        wire_u1=put(d.get("wire_u1")), wire_u2=put(d.get("wire_u2")))
                  for d in saved["draws"])
    return PendingSelection(put(saved["slots"]), put(saved["scaled_probs"]), draws)


def cosine_decay_schedule(lr: float, decay_steps: int) -> Schedule:
    """``lr·½(1 + cos(π·min(k, T)/T))`` (optax, ``alpha=0``)."""
    def schedule(k: int) -> float:
        frac = min(k, decay_steps) / decay_steps
        return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    return schedule


def warmup_cosine_decay_schedule(lr: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """Linear 0 → ``lr`` over ``warmup_steps``, then cosine to 0 at
    ``decay_steps`` (which counts the warmup, as optax's does)."""
    cosine = cosine_decay_schedule(lr, decay_steps - warmup_steps)

    def schedule(k: int) -> float:
        if k < warmup_steps:
            return lr * k / warmup_steps
        return cosine(k - warmup_steps)
    return schedule


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], lr: float,
                   total_steps: int, weight_decay: float = 0.0,
                   warmup_steps: int = 0, grad_accum_steps: int = 1
                   ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """Optimizer and its per-update learning rate, as
    ``mercury_tpu.train.state.make_optimizer`` builds them: Adam (L2 decay
    added to the gradient, as ``optax.add_decayed_weights`` before Adam),
    AdamW (decoupled decay) or SGD with momentum 0.9. With
    ``grad_accum_steps=A`` the schedule runs over ``ceil(total_steps/A)``
    updates and its warmup over ``ceil(warmup_steps/A)``; warmup updates
    that leave no decay raise."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    updates = max(-(-total_steps // grad_accum_steps), 1)
    if warmup_steps > 0:
        w_updates = -(-warmup_steps // grad_accum_steps)
        if w_updates >= updates:
            raise ValueError(
                f"warmup_steps ({warmup_steps}) must leave decay room after "
                f"accumulation: warmup updates ({w_updates}) >= total "
                f"updates ({updates})")
        schedule = warmup_cosine_decay_schedule(lr, w_updates, updates)
    else:
        schedule = cosine_decay_schedule(lr, updates)
    params = list(params)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return opt, schedule


@dataclasses.dataclass
class MercuryState:
    """Everything one step reads and advances."""

    step: int                        # steps (microsteps) taken so far
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Schedule
    ema: EMAState                    # on the device
    stream: ShardStream              # perm on the device, cursor on the host
    generator: torch.Generator       # the step's draws, on the device
    # sampler="scoretable" only: the [L] table on the device, cursor on the host
    scoretable: Optional[ScoreTableState] = None
    updates: int = 0                 # optimizer updates applied (= step at A=1)
    mini_step: int = 0               # microsteps folded into accum since the last update
    # grad_accum_steps > 1 only: the float32 running mean of this window's
    # gradients, one tensor a parameter in model.parameters() order (under
    # zero_sharding one: this rank's chunk)
    accum: Optional[List[torch.Tensor]] = None
    # sampler="scoretable" with telemetry only: this rank's [L] int32 ledger
    # of trained slots on the device, one count an occurrence
    sel_counts: Optional[torch.Tensor] = None
    # data_placement="host_stream" only, once primed: the selections in
    # flight. The stream (pool, uniform) is then the lookahead's, depth
    # pools ahead of the step.
    pending: Optional[PendingSelection] = None
    # pipelined_scoring only: the batch step+1 trains on (the JAX state's
    # ``pending``; a placeholder until step 0 boots)
    pending_batch: Optional[PendingBatch] = None
    # score_refresh_every > 1 only: the pool the steps between refreshes
    # redraw from (a uniform placeholder until step 0 refreshes)
    cached_pool: Optional[CachedPool] = None
    # sampler="groupwise" only: the shard's importance and group tags on the
    # device, cursor and generation on the host
    groupwise: Optional[GroupwiseState] = None
    # the JAX flat order and ZeRO's chunking, built by flat_layout() on
    # first use (never changed, so clones share it)
    flat: Optional[FlatLayout] = None
    # the rank's place in the mesh (None: a data-only run over the default
    # group); clones share it
    mesh: Any = None
    # under a second mesh axis, the per-leaf int8 wire's layout, built by
    # wire_layout() on first use (clones share it)
    wire: Optional[Tuple[LeafWire, ...]] = None

    def clone(self) -> "MercuryState":
        """An independent copy: the model and its optimizer are copied
        together, so the copy's optimizer state points at the copy's
        parameters."""
        model, optimizer = copy.deepcopy((self.model, self.optimizer))
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.generator.get_state())
        table = self.scoretable
        if table is not None:
            table = ScoreTableState(table.scores.clone(), table.cursor)
        return dataclasses.replace(
            self, model=model, optimizer=optimizer, generator=gen,
            ema=EMAState(self.ema.value.clone(), self.ema.count.clone()),
            stream=ShardStream(self.stream.perm.clone(), self.stream.cursor),
            scoretable=table,
            accum=None if self.accum is None else [a.clone() for a in self.accum],
            sel_counts=None if self.sel_counts is None else self.sel_counts.clone(),
            pending=clone_pending(self.pending),
            pending_batch=clone_pending(self.pending_batch),
            cached_pool=clone_pending(self.cached_pool),
            groupwise=clone_pending(self.groupwise),
        )


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: ``seed`` itself at rank 0, a
    number drawn from ``(seed, rank)`` at every other rank, so ranks draw
    different crops, flips, uniforms and reshuffles (the JAX package's
    per-worker keys)."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


def create_state(model: torch.nn.Module, device: torch.device, seed: int,
                 shard_len: int, optimizer: str, lr: float, total_steps: int,
                 weight_decay: float = 0.0,
                 warmup_steps: int = 0,
                 with_scoretable: bool = False,
                 rank: int = 0,
                 grad_accum_steps: int = 1,
                 with_sel_counts: bool = False,
                 with_groupwise: bool = False,
                 pending_batch_size: int = 0,
                 pending_sample_shape: Tuple[int, ...] = (32, 32, 3),
                 cached_pool_size: int = 0,
                 world_size: int = 1,
                 zero_sharding: bool = False) -> MercuryState:
    """Move ``model`` to ``device`` and build its optimizer, a fresh EMA,
    the worker's stream and a generator seeded with ``rank_seed(seed,
    rank)``; with ``with_scoretable`` also a score table of ones over the
    shard, cursor 0; with ``grad_accum_steps > 1`` a zero accumulator; with
    ``with_sel_counts`` a zero ledger over the shard; with
    ``with_groupwise`` the groupwise state over the shard. The modes'
    placeholders are the JAX package's: ``pending_batch_size=B`` a batch of
    zero images of ``pending_sample_shape`` (after augmentation), zero
    labels and unit weights; ``cached_pool_size=P`` zero slots under the
    uniform distribution. With ``zero_sharding`` the optimizer runs over
    one float32 tensor of ``zero_chunk_size(n, world_size)``, this rank's
    chunk of the flat parameters (the step copies the parameters into it
    before each update), and the accumulator is chunk-shaped. The model arrives with its weights: the same on every
    rank."""
    device = torch.device(device)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    params = list(model.parameters())
    if zero_sharding:
        chunk = zero_chunk_size(sum(p.numel() for p in params), world_size)
        params = [torch.nn.Parameter(torch.zeros(chunk, dtype=torch.float32, device=device))]
    opt, schedule = make_optimizer(optimizer, params, lr,
                                   total_steps, weight_decay, warmup_steps,
                                   grad_accum_steps)
    gen = torch.Generator(device=device)
    gen.manual_seed(rank_seed(seed, rank))
    stream = init_shard_streams(gen, 1, shard_len)[0]
    table = init_score_table(shard_len, device) if with_scoretable else None
    accum = None
    if grad_accum_steps > 1:
        accum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    sel_counts = None
    if with_sel_counts:
        sel_counts = torch.zeros(shard_len, dtype=torch.int32, device=device)
    pending_batch = cached_pool = None
    if pending_batch_size:
        b = pending_batch_size
        pending_batch = PendingBatch(
            images=torch.zeros((b, *pending_sample_shape), dtype=torch.float32, device=device),
            labels=torch.zeros(b, dtype=torch.int32, device=device),
            scaled_probs=torch.ones(b, dtype=torch.float32, device=device))
    if cached_pool_size:
        p = cached_pool_size
        cached_pool = CachedPool(
            slots=torch.zeros(p, dtype=torch.long, device=device),
            probs=torch.full((p,), 1.0 / p, dtype=torch.float32, device=device),
            pool_loss=torch.zeros((), dtype=torch.float32, device=device))
    return MercuryState(step=0, model=model, optimizer=opt,
                        lr_schedule=schedule, ema=init_ema(device),
                        stream=stream, generator=gen, scoretable=table,
                        accum=accum, sel_counts=sel_counts,
                        pending_batch=pending_batch, cached_pool=cached_pool,
                        groupwise=init_groupwise(shard_len, device) if with_groupwise else None)


def flat_layout(state: MercuryState) -> FlatLayout:
    """The state's :class:`FlatLayout` over the ranks of the default
    process group, built from the model the first time ZeRO's step or the
    int8 wire asks for it and kept on the state."""
    if state.flat is None:
        state.flat = FlatLayout(*jax_flat_order(state.model),
                               world=collectives.world(), rank=collectives.rank())
    return state.flat


def wire_layout(state: MercuryState) -> Tuple[LeafWire, ...]:
    """The state's :class:`LeafWire` a parameter, in
    ``model.parameters()`` order, built from the model and its sharding
    the first time the per-leaf int8 wire asks for it and kept on the
    state: each leaf's chunk dim is JAX's ``wire_chunk_dim`` of its whole
    Flax shape, avoiding the dim the second axis splits."""
    if state.wire is None:
        model = state.model
        sh = sharding_of(model)
        params = dict(model.named_parameters())
        axis = state.mesh.axis_names[1] if state.mesh is not None and state.mesh.second > 1 \
            else "model"
        wire = []
        for name, path, axes in flax_leaves(model):
            local = params[name].shape
            split_torch = None if sh is None else sh.dims.get(name)
            shape = tuple(local[a] * (sh.size if a == split_torch else 1) for a in axes)
            split = None if split_torch is None else axes.index(split_torch)
            spec = tuple(axis if i == split else None for i in range(len(shape)))
            wire.append(LeafWire(path, tuple(axes), shape, spec,
                                 collectives.wire_chunk_dim(shape, spec), split))
        state.wire = tuple(wire)
    return state.wire
