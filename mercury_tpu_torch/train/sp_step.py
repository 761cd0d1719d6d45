"""Training steps on a 2-D ``data × seq`` mesh — the port of
``mercury_tpu/train/sp_step.py``.

Each example's token axis is split over a second mesh axis, the sequence
group, and every self-attention runs sequence-parallel
(``parallel/sequence.py``): context length then grows with the group, and
no rank holds a whole sequence's activations or an ``[L, L]`` score
matrix. The mesh is ``make_tp_mesh(world_size, S, "data", "seq")``
(``parallel/mesh.py``): ``world_size × S`` ranks, one process each, the
sequence axis innermost; global rank ``r`` is data worker ``r // S`` and
holds window ``r % S`` of the tokens. The model is built with
``sp_axis="seq"`` (and ``sp_impl``), and the step builders bind the mesh's
sequence group to it (``bind_sequence_group``).

Each rank holds its worker's row of the sampler state
(:class:`SpMercuryState`): the EMA, the stream over the ``N`` training rows
and a generator seeded from the **data** rank, so the ranks of a sequence
group draw the same pools and batches — the selection is computed
redundantly, not communicated (JAX's ``[Wd]``-stacked rows, one a
process here).

The gradient. The JAX step runs its ``shard_map`` with replication checks
off, so the head's ``pmean`` over ``seq`` transposes as a ``psum``: every
rank's gradient comes out S times its share (the pre-pool parameters' from
the pooled gradient summed over the S copies of the loss, the head's from
its whole gradient on every rank), and the step divides once, by a ``psum``
over both axes and ``Wd·S``. The port copies that convention: the model's
sequence mean is ``collectives.AllReduceMean``, whose backward sums the
ranks' gradients and divides by S — S times the exact transpose's, since
each rank's copy of the loss sends the same gradient — and the step
all-reduces the gradients over all ``Wd·S`` ranks (the default group) and
divides by ``Wd·S``. One uniform division then lands every leaf on the
workers' mean gradient, and the reduction is JAX's, a sum over both axes
before one divide; the exact transpose would need the pre-pool and
post-pool leaves reduced apart. The MoE router loss, averaged over the
group by the same all-reduce, is scaled the same way.

A zigzag model (``sp_impl="zigzag"``) reads the token axis in
``zigzag_order``: the step gathers each rank's window of the permuted
tokens, so callers feed sequence-ordered data. The token count ``T`` must
divide by S.

JAX's ``io_constraints`` (``with_sharding_constraint`` pins of the
replicated inputs) has no torch role: each process holds its own copy of
``x_train`` and ``y_train`` and gathers its window of the pooled rows.

Entry points run on the card (``parallel.distributed.device()``) unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.data.pipeline import ShardStream, init_shard_streams, next_pool
from mercury_tpu_torch.obs.diagnostics import (
    clip_fraction,
    ema_drift,
    ess_fraction,
    global_grad_norm,
)
from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll, score_and_draw
from mercury_tpu_torch.parallel.collectives import allreduce_mean_
from mercury_tpu_torch.parallel.distributed import device as rank_device
from mercury_tpu_torch.parallel.mesh import GroupRef, Mesh, model_group
from mercury_tpu_torch.parallel.sequence import bind_sequence_group, zigzag_order
from mercury_tpu_torch.sampling.importance import (
    EMAState,
    ema_update,
    init_ema,
    pool_mean,
    reweighted_loss,
)
from mercury_tpu_torch.train.state import Draws, rank_seed


def _bound(model: torch.nn.Module, mesh: Mesh) -> GroupRef:
    """Bind the mesh's sequence group (its second axis's, or a group of one
    on a data-only mesh) to ``model`` and return it (a model without
    ``sp_axis`` must run on a mesh of one window)."""
    group = model_group(mesh)
    if getattr(model, "sp_axis", None) is not None:
        bind_sequence_group(model, group)
    elif group.size > 1:
        raise ValueError(f"a {mesh.shape} mesh needs a model built with sp_axis")
    return group


def token_window(t: int, group: GroupRef, zigzag: bool, device) -> torch.Tensor:
    """This rank's token positions of a ``T``-token sequence: window
    ``rank`` of S, of the ``zigzag_order`` layout under zigzag."""
    s = group.size
    if t % s != 0:
        # Silent truncation would train on other math than the unsharded run.
        raise ValueError(f"sequence length {t} must divide by the 'seq' axis size {s}")
    t_loc = t // s
    lo = group.rank * t_loc
    if zigzag:
        return torch.as_tensor(zigzag_order(t, s)[lo:lo + t_loc], device=device)
    return torch.arange(lo, lo + t_loc, device=device)


def _sync_grads(model: torch.nn.Module) -> None:
    """Every parameter's gradient summed over all ``Wd·S`` ranks and
    divided by ``Wd·S`` (module docstring), one bucket."""
    allreduce_mean_([p.grad for p in model.parameters() if p.grad is not None])


def _objective(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor,
               moe_aux_weight: float, weights: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """The train forward's loss: the mean per-sample NLL (reweighted by
    ``weights``, the drawn samples' ``p·P``), plus ``moe_aux_weight`` times
    the router loss where the model has experts."""
    logits, aux = model(x, return_aux=True)
    losses = per_sample_nll(logits, y)
    total = losses.mean() if weights is None else reweighted_loss(losses, weights)
    if getattr(model, "moe_experts", None) is not None:
        total = total + moe_aux_weight * aux
    return total


def make_dp_sp_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          mesh: Mesh, moe_aux_weight: float = TrainConfig.moe_aux_weight,
                          device=None) -> Callable[..., torch.Tensor]:
    """``step(x, y) → loss``: one plain step of ``model`` (built with
    ``sp_axis``) and ``optimizer`` (over its parameters) on the mesh. ``x``
    ``[B, T, F]`` and ``y`` ``[B]`` are the whole batch on every rank, in
    sequence order; a rank trains on its worker's ``B/Wd`` rows and its
    window of their tokens. The loss is the mean NLL plus
    ``moe_aux_weight`` times the router loss, averaged over the data
    group; the model and optimizer advance in place."""
    group = _bound(model, mesh)
    model.to(rank_device() if device is None else torch.device(device))
    zigzag = getattr(model, "sp_impl", "ring") == "zigzag"
    wd = mesh.world_size

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % wd != 0:
            raise ValueError(f"batch {b} must divide by the 'data' axis size {wd}")
        rows = slice(mesh.data_rank * (b // wd), (mesh.data_rank + 1) * (b // wd))
        cols = token_window(x.shape[1], group, zigzag, x.device)
        loss = _objective(model, x[rows][:, cols], y[rows], moe_aux_weight)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _sync_grads(model)
        optimizer.step()
        return allreduce_mean_([loss.detach().clone()], mesh.data_group)[0]

    return step


@dataclasses.dataclass
class SpMercuryState:
    """One rank's state of the ``data × seq`` Mercury step: the model and
    its optimizer (replicas), and its worker's sampler row — the EMA, the
    stream over the training rows and the generator, equal on every rank
    of a sequence group."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: EMAState
    stream: ShardStream
    generator: torch.Generator
    step: int = 0


def init_sp_mercury_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          mesh: Mesh, shard_len: int, seed: int = 0,
                          device=None) -> SpMercuryState:
    """The state of a rank of ``mesh``: ``model`` (with its weights, the
    same on every rank) moved to ``device``, ``optimizer`` over its
    parameters, a fresh EMA, and a stream over ``shard_len`` rows drawn
    from a generator seeded with ``rank_seed(seed, data rank)``."""
    dev = rank_device() if device is None else torch.device(device)
    model.to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(rank_seed(seed, mesh.data_rank))
    stream = init_shard_streams(gen, 1, shard_len)[0]
    return SpMercuryState(model=model, optimizer=optimizer, ema=init_ema(dev),
                          stream=stream, generator=gen)


def sp_draws(state: SpMercuryState, pool_size: int, batch_size: int) -> Draws:
    """One step's draws from the state's generator: the stream's next
    permutation where the pool wraps it, then the draw's ``[1, B]``
    uniforms."""
    gen = state.generator
    perm = None
    if state.stream.cursor + pool_size > state.stream.perm.shape[0]:
        perm = torch.randperm(state.stream.perm.shape[0], generator=gen, device=gen.device)
    return Draws(perm=perm, aug=None,
                 uniforms=torch.rand((1, batch_size), generator=gen, device=gen.device))


def make_dp_sp_mercury_step(model: torch.nn.Module, mesh: Mesh, batch_size: int,
                            presample_batches: int = 10, is_alpha: float = 0.5,
                            ema_alpha: float = 0.9,
                            moe_aux_weight: float = TrainConfig.moe_aux_weight,
                            telemetry: bool = False
                            ) -> Callable[..., Tuple[SpMercuryState, Dict[str, torch.Tensor]]]:
    """The Mercury importance-sampled step on the ``data × seq`` mesh:
    ``step(state, x_train, y_train, draws=None) → (state, metrics)``, the
    state advanced in place. ``model`` is the state's model (built with
    ``sp_axis``; the step binds the mesh's sequence group to it);
    ``x_train`` ``[N, T, F]`` and ``y_train`` ``[N]`` are the whole
    training set on every rank's device, in sequence order. ``draws``
    (default :func:`sp_draws`) are the stream's permutation and the draw's
    uniforms; tests pass the JAX step's.

    Per step, on every rank of a worker alike: the next ``P = presample ×
    B`` rows of the stream, this rank's token window of each
    (:func:`token_window`); a no-grad scoring forward and per-sample NLL (the
    ``nll_fwd`` kernel); the EMA of the pool mean over the **data** group;
    the draw (``score_and_draw`` kernel); the reweighted loss ``mean(l /
    (P·p))`` of the drawn rows (``nll_fwd``, and ``nll_bwd`` in the
    backward), plus ``moe_aux_weight`` times the router loss where the
    model has experts; the gradient's sum over all ranks divided by
    ``Wd·S`` (module docstring); the optimizer's step. Metrics:
    ``train/loss`` (mean over the data group), ``train/pool_loss`` (the
    global pool mean), ``sampler/selected`` (the drawn pool positions),
    and with ``telemetry`` ``sampler/ess`` and ``sampler/clip_frac`` (means
    over the data group), ``sampler/ema_drift`` and ``train/grad_norm``
    (of the synced gradient)."""
    group = _bound(model, mesh)
    pool = presample_batches * batch_size
    zigzag = getattr(model, "sp_impl", "ring") == "zigzag"
    dgroup = mesh.data_group

    def step(state: SpMercuryState, x_train: torch.Tensor, y_train: torch.Tensor,
             draws: Optional[Draws] = None) -> Tuple[SpMercuryState, Dict[str, torch.Tensor]]:
        if state.model is not model:
            raise ValueError("the state's model is not the step's")
        cols = token_window(x_train.shape[1], group, zigzag, x_train.device)
        if draws is None:
            draws = sp_draws(state, pool, batch_size)

        def new_perm() -> torch.Tensor:
            if draws.perm is None:
                raise ValueError("the pool wraps the stream: the draws need perm")
            return draws.perm

        stream, slots = next_pool(state.stream, pool, new_perm)
        pool_x = x_train[slots[:, None], cols]                 # [P, T/S, F]
        pool_y = y_train[slots]
        with torch.no_grad():
            pool_losses = per_sample_nll(model(pool_x), pool_y)
        mean_loss = pool_mean(pool_losses, sync=True, group=dgroup)
        ema = ema_update(state.ema, mean_loss, ema_alpha)
        _, selected, scaled_probs = score_and_draw(pool_losses, ema.value,
                                                   draws.uniforms, is_alpha)
        selected = selected.long()
        state.optimizer.zero_grad(set_to_none=True)
        loss = _objective(model, pool_x[selected], pool_y[selected], moe_aux_weight,
                          scaled_probs)
        loss.backward()
        _sync_grads(model)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = global_grad_norm(grads) if telemetry else None
        state.optimizer.step()
        scalars = [loss.detach()]
        if telemetry:
            scalars += [ess_fraction(scaled_probs),
                        clip_fraction(pool_losses, ema.value, is_alpha)]
        means = allreduce_mean_([torch.stack(scalars).float()], dgroup)[0]
        metrics = {"train/loss": means[0], "train/pool_loss": mean_loss,
                   "sampler/selected": selected}
        if telemetry:
            metrics.update({"sampler/ess": means[1], "sampler/clip_frac": means[2],
                            "sampler/ema_drift": ema_drift(mean_loss, state.ema.value),
                            "train/grad_norm": grad_norm})
        state.ema, state.stream = ema, stream
        state.step += 1
        return state, metrics

    return step


__all__ = ["SpMercuryState", "init_sp_mercury_state", "make_dp_sp_mercury_step",
           "make_dp_sp_train_step", "sp_draws", "token_window"]
