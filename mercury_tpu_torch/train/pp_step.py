"""The Mercury importance-sampled step on a pipelined model — the port of
``mercury_tpu/train/pp_step.py``.

One data worker whose model is staged over the mesh's pipe group
(``make_tp_mesh(1, S, "data", "pipe")``, ``parallel/pipeline.py``): each
of the S ranks holds ``L/S`` of the Transformer's (or ViT's) blocks, their
gradients and their Adam moments, and the embedding and head whole. The
candidate pool is scored through the GPipe schedule, the batch drawn by the
EMA-smoothed ``loss + α·EMA`` rule, and the reweighted loss trained through
the schedule's exact backward.

Each rank holds the worker's sampler state (:data:`PPMercuryState`, the
fields of ``train/sp_step.SpMercuryState``): the EMA, the stream over the
training rows and a generator seeded alike on every rank, so the stages
draw the same pools and batches — computed redundantly, not communicated.
The Transformer family has no BatchNorm, so the scoring and the training
forwards are one function.

The gradient follows JAX's ``shard_map`` (``parallel/pipeline.py``'s
docstring): a block's gradient is whole on the rank that holds it, and the
replicated parameters' shares are summed over the pipe group
(``reduce_replicated_grads``). The telemetry's gradient norm counts each
block once (the blocks' squared norms summed over the pipe group), each
expert once, and the replicated parameters once.

On a mesh with two model axes (``parallel/mesh.make_pp_mesh``), as JAX's
step runs on one:

- **pipe × seq**: each rank takes its window of the pool's and the
  batch's tokens (``sp_step``'s windows, the zigzag layout's under
  ``sp_impl="zigzag"``); the logits are whole on every rank, so every rank
  scores, draws and weighs the whole batch;
- **pipe × expert**: rank ``e`` of the expert group of W scores pool rows
  ``[e·P/W, (e+1)·P/W)``, and one all-gather over the group makes the
  per-sample losses whole on every rank; every rank draws the same batch
  from them and trains its rows ``[e·B/W, (e+1)·B/W)``. The reweighted
  loss is the ranks' shares summed over the group
  (``collectives.shard_sum``), and the accuracy is over the whole batch:
  both JAX's, computed on global arrays. Pool and batch must divide by
  ``W·M``.

JAX's ``io_constraints`` (``with_sharding_constraint`` pins of the
replicated inputs) has no torch role: each process holds its own copy of
``x_train`` and ``y_train``.

Entry points run on the card (``parallel.distributed.device()``) unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.data.pipeline import next_pool
from mercury_tpu_torch.obs.diagnostics import (
    clip_fraction,
    ema_drift,
    ess_fraction,
    global_grad_norm,
)
from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll, score_and_draw
from mercury_tpu_torch.models.moe import expert_leaf_names
from mercury_tpu_torch.parallel.collectives import shard_mean, shard_sum
from mercury_tpu_torch.parallel.mesh import GroupRef, Mesh, gather_dim, inner_group
from mercury_tpu_torch.parallel.pipeline import (
    check_staged,
    make_pp_apply,
    model_axes,
    reduce_replicated_grads,
)
from mercury_tpu_torch.sampling.importance import ema_update, pool_mean, reweighted_loss
from mercury_tpu_torch.train.sp_step import (
    SpMercuryState,
    init_sp_mercury_state,
    sp_draws,
    token_window,
)
from mercury_tpu_torch.train.state import Draws

# A pipe rank's state is a data × seq rank's: the model (here its stage), the
# optimizer over it, and the worker's EMA, stream and generator.
PPMercuryState = SpMercuryState
pp_draws = sp_draws


def create_pp_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh: Mesh,
                    shard_len: int, seed: int = 0, device=None) -> PPMercuryState:
    """The state of a rank of the pipe mesh: ``model``, staged by
    ``shard_stacked_blocks`` before ``optimizer`` was built over its
    parameters, moved to ``device``; a fresh EMA; a stream over
    ``shard_len`` rows from a generator seeded with ``seed`` on every
    rank."""
    check_staged(model, mesh)
    return init_sp_mercury_state(model, optimizer, mesh, shard_len, seed, device)


def _grad_norm(model: torch.nn.Module, group: GroupRef, experts: GroupRef) -> torch.Tensor:
    """The whole model's gradient norm: the blocks' squares summed over
    the pipe group, the expert-parallel leaves' over the expert group
    ``experts`` too, the replicated parameters' once."""
    split = expert_leaf_names(model)
    named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    blocks: List[torch.Tensor] = [g for n, g in named if n.startswith("blocks.")
                                  and n not in split]
    rest = [g for n, g in named if not n.startswith("blocks.")]
    own = [g for n, g in named if n in split]
    squares = global_grad_norm(blocks).square()
    if own:
        squares = squares + shard_sum(global_grad_norm(own).square(), experts)
    return torch.sqrt(shard_sum(squares, group) + global_grad_norm(rest).square())


def make_pp_mercury_step(model: torch.nn.Module, mesh: Mesh, batch_size: int,
                         presample_batches: int = 10, num_microbatches: int = 2,
                         is_alpha: float = 0.5, ema_alpha: float = 0.9,
                         moe_aux_weight: float = TrainConfig.moe_aux_weight,
                         telemetry: bool = False
                         ) -> Callable[..., Tuple[PPMercuryState, Dict[str, torch.Tensor]]]:
    """The Mercury step on the pipe mesh: ``step(state, x_train, y_train,
    draws=None) → (state, metrics)``, the state advanced in place.
    ``model`` is the state's staged model; ``x_train`` (``[N, T, F]``, or
    model-ready NCHW images for a ``patch_size`` model) and ``y_train``
    ``[N]`` are the worker's rows on every rank's device. The pool
    (``presample_batches × batch_size``) and the batch both run through the
    schedule, so both must divide by ``num_microbatches`` (by W times it on
    a pipe × expert mesh, whose ranks take W slices; module docstring).
    ``draws``
    (default :func:`pp_draws`) are the stream's permutation and the draw's
    uniforms; tests pass the JAX step's.

    Per step, on every rank alike: the next pool of the stream; a no-grad
    scoring pass through the schedule and per-sample NLL (the ``nll_fwd``
    kernel); the EMA of the pool mean; the draw (``score_and_draw``
    kernel); the reweighted loss ``mean(l / (P·p))`` of the drawn rows
    through the schedule (``nll_fwd``, and ``nll_bwd`` in the backward),
    plus ``moe_aux_weight`` times the router loss where the model has
    experts; the gradients completed by ``reduce_replicated_grads``; the
    optimizer's step. Metrics, JAX's keys: ``train/loss``, ``train/acc``,
    ``train/pool_loss``, ``train/moe_aux`` (0 without experts), and with
    ``telemetry`` ``sampler/ess``, ``sampler/clip_frac``,
    ``sampler/ema_drift`` and ``train/grad_norm``; and ``sampler/selected``,
    the drawn pool positions."""
    pool = presample_batches * batch_size
    sp, ep = model_axes(model, mesh)
    inner = inner_group(mesh)
    # The expert group, which splits the pool and the batch; of one but
    # under ep.
    experts = inner if ep is not None else GroupRef(None, 1, 0)
    w = experts.size
    if pool % (w * num_microbatches) or batch_size % (w * num_microbatches):
        raise ValueError(f"pool ({pool}) and batch ({batch_size}) must divide by "
                         + (f"num_microbatches ({num_microbatches})" if w == 1 else
                            f"the {ep!r} axis size × num_microbatches ({w}×{num_microbatches})"))
    moe = model.moe_experts is not None
    apply = make_pp_apply(model, mesh, num_microbatches, with_aux=moe)
    group = check_staged(model, mesh)
    zigzag = model.sp_impl == "zigzag"
    # This rank's pool rows and batch rows (all of them but under ep).
    e = experts.rank
    pool_rows = slice(e * pool // w, (e + 1) * pool // w)
    batch_rows = slice(e * batch_size // w, (e + 1) * batch_size // w)

    def forward(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = apply(x)
        return out if moe else (out, torch.zeros((), device=out.device))

    def step(state: PPMercuryState, x_train: torch.Tensor, y_train: torch.Tensor,
             draws: Optional[Draws] = None) -> Tuple[PPMercuryState, Dict[str, torch.Tensor]]:
        if state.model is not model:
            raise ValueError("the state's model is not the step's")
        if draws is None:
            draws = pp_draws(state, pool, batch_size)

        def new_perm() -> torch.Tensor:
            if draws.perm is None:
                raise ValueError("the pool wraps the stream: the draws need perm")
            return draws.perm

        stream, slots = next_pool(state.stream, pool, new_perm)
        if sp is not None:
            cols = token_window(x_train.shape[1], inner, zigzag, x_train.device)
            pool_x = x_train[slots[:, None], cols]                 # [P, T/N, F]
        else:
            pool_x = x_train[slots]
        pool_y = y_train[slots]
        with torch.no_grad():
            pool_losses = gather_dim(per_sample_nll(forward(pool_x[pool_rows])[0],
                                                    pool_y[pool_rows]), 0, experts)
        mean_loss = pool_mean(pool_losses)
        ema = ema_update(state.ema, mean_loss, ema_alpha)
        _, selected, scaled_probs = score_and_draw(pool_losses, ema.value, draws.uniforms,
                                                   is_alpha)
        selected = selected.long()
        mine = selected[batch_rows]
        y = pool_y[mine]
        state.optimizer.zero_grad(set_to_none=True)
        logits, aux = forward(pool_x[mine])
        # JAX's means over the whole batch: this rank's shares, summed over
        # the expert group.
        loss = shard_sum(reweighted_loss(per_sample_nll(logits, y),
                                         scaled_probs[batch_rows]) / w, experts)
        acc = shard_mean((logits.detach().argmax(-1) == y).float().mean(), experts)
        if moe:
            loss = loss + moe_aux_weight * aux
        loss.backward()
        reduce_replicated_grads(model, mesh)
        grad_norm = _grad_norm(model, group, experts) if telemetry else None
        state.optimizer.step()
        metrics = {"train/loss": loss.detach(), "train/acc": acc,
                   "train/pool_loss": mean_loss, "train/moe_aux": aux.detach(),
                   "sampler/selected": selected}
        if telemetry:
            metrics.update({"sampler/ess": ess_fraction(scaled_probs),
                            "sampler/clip_frac": clip_fraction(pool_losses, ema.value,
                                                               is_alpha),
                            "sampler/ema_drift": ema_drift(mean_loss, state.ema.value),
                            "train/grad_norm": grad_norm})
        state.ema, state.stream = ema, stream
        state.step += 1
        return state, metrics

    return step


__all__ = ["PPMercuryState", "create_pp_state", "make_pp_mercury_step", "pp_draws"]
