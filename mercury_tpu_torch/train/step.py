"""The Mercury step of the port, at one worker.

The PyTorch counterpart of the pool and sync-scoretable branches of
``mercury_tpu.train.step.make_train_step`` and of its ``train_update``.
A pool step (``sampler="pool"``):

1. takes the next ``P = presample_batches × batch_size`` slots of the
   worker's shuffled stream (``next_pool``);
2. gathers their uint8 rows from the device-resident dataset and ingests
   them (:func:`ingest`: normalize, crop with pad 4, horizontal flip);
3. runs a train-mode scoring forward over the pool — batch statistics, the
   running statistics left as they were — without gradients;
4. scores every candidate by its per-sample NLL (``nll_fwd`` kernel);
5. updates the EMA of the mean pool loss, then smooths, normalizes and
   draws the batch by inverse CDF (``score_and_draw`` kernel);
6. trains on the drawn batch with the reweighted loss ``mean(loss/(N·p))``
   (``nll_fwd`` forward, ``nll_bwd`` backward) and applies the optimizer.

A scoretable step (``sampler="scoretable"``) keeps a score for every slot
of the shard instead of a stream:

1. the refresh window ``(cursor + arange(R)) % L``: gather, ingest, scoring
   forward and ``nll_fwd`` as above, over ``R`` rows;
2. the EMA update from the window's mean score;
3. decay, scatter of the window's scores, normalization and draw over the
   whole table (``table_refresh_draw`` kernel);
4. gather and ingest of the drawn slots, and the same reweighted update
   (``p·L`` in place of ``p·N``);
5. the write-back: the trained batch's per-sample losses, already computed
   for the loss, are scatter-averaged into the table (no third ``nll_fwd``
   launch), and the cursor advances by ``R``. The stream is not read.

With ``fused_input`` every ingest is one ``augment_normalize`` kernel
launch from the uint8 rows. At one worker the gradient and BN-statistic
means over workers are the identity, so there are no collectives. With
``use_importance_sampling=False`` the step is the uniform control arm: the
streamed batch itself, weight 1.

The step's random numbers are one :class:`Draws`: by default made from the
state's generator on the device; tests pass the JAX package's draws instead.
On the card, with ``compute_dtype="bfloat16"``, forwards run under bf16
autocast and the logits come back in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.data.pipeline import (
    ShardedDataset,
    augment_batch,
    next_pool,
    normalize_images,
)
from mercury_tpu_torch.ops import reference
from mercury_tpu_torch.ops.mercury_kernels import (
    augment_normalize,
    per_sample_nll,
    score_and_draw,
    table_refresh_draw,
)
from mercury_tpu_torch.sampling.importance import (
    ema_update,
    pool_mean,
    reweighted_loss,
)
from mercury_tpu_torch.sampling.scoretable import (
    ScoreTableState,
    advance_cursor,
    refresh_window,
    scatter_mean,
)
from mercury_tpu_torch.train.state import MercuryState

CROP_PAD = 4


def to_nchw(images: torch.Tensor) -> torch.Tensor:
    """The model's NCHW view of NHWC images: channels_last in memory on
    the card; a contiguous copy on the CPU, where the backward through this
    network from a channels_last input aborted with heap corruption
    (torch 2.13.0+cpu)."""
    x = images.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


class Draws(NamedTuple):
    """The random numbers of one step. ``crop``/``flip`` augment the rows
    scored first — the pool, or the scoretable's refresh window (the JAX
    step's ``k_aug``); ``crop2``/``flip2`` augment the drawn train batch of
    the scoretable step, which gathers its rows anew (``k_aug2``)."""

    perm: Optional[torch.Tensor]  # [L] reshuffle permutation; read only if the stream wraps
    crop: torch.Tensor            # [P or R, 2] int32 crop offsets in [0, 2·pad]
    flip: torch.Tensor            # [P or R] bool horizontal flips
    uniforms: Optional[torch.Tensor]  # [1, B] float32 U(0,1) of the draw (IS only)
    crop2: Optional[torch.Tensor] = None  # [B, 2] int32 (scoretable only)
    flip2: Optional[torch.Tensor] = None  # [B] bool (scoretable only)


def pool_size(config: TrainConfig) -> int:
    return (config.candidate_pool_size if config.use_importance_sampling
            else config.batch_size)


def make_draws(state: MercuryState, config: TrainConfig) -> Draws:
    """One step's draws from the state's generator, on its device."""
    gen = state.generator
    dev = gen.device

    def augment_draws(n: int):
        crop = torch.randint(0, 2 * CROP_PAD + 1, (n, 2), generator=gen,
                             device=dev, dtype=torch.int32)
        return crop, torch.rand(n, generator=gen, device=dev) < 0.5

    def uniforms():
        return torch.rand((1, config.batch_size), generator=gen, device=dev)

    if config.use_scoretable:
        crop, flip = augment_draws(config.refresh_size)
        crop2, flip2 = augment_draws(config.batch_size)
        return Draws(perm=None, crop=crop, flip=flip, uniforms=uniforms(),
                     crop2=crop2, flip2=flip2)
    p = pool_size(config)
    length = state.stream.perm.shape[0]
    perm = None
    if state.stream.cursor + p > length:
        perm = torch.randperm(length, generator=gen, device=dev)
    crop, flip = augment_draws(p)
    return Draws(perm=perm, crop=crop, flip=flip,
                 uniforms=uniforms() if config.use_importance_sampling else None)


def make_train_step(
    config: TrainConfig, dataset: ShardedDataset,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step_fn(state, draws=None, use_kernels=True) → metrics``.

    ``step_fn`` advances ``state`` in place (model, optimizer, EMA, stream
    or score table, step) and returns the step's metrics as device tensors
    — scalars, the ``[B]`` pool positions or table slots drawn and the
    distribution they were drawn from — so a caller that does not read
    them never waits for the device.
    ``use_kernels=False`` swaps the kernels for their plain versions on the
    same device — for holding one against the other, not for training."""
    use_is = config.use_importance_sampling
    use_table = config.use_scoretable
    p_size = pool_size(config)
    batch_size = config.batch_size
    refresh_size = config.refresh_size
    bf16 = config.compute_dtype == "bfloat16"
    data_dev = dataset.x_train.device
    mean_t = torch.as_tensor(dataset.mean, dtype=torch.float32, device=data_dev)
    std_t = torch.as_tensor(dataset.std, dtype=torch.float32, device=data_dev)

    def gather(slots: torch.Tensor):
        gidx = dataset.shard_indices[0][slots]
        return dataset.x_train[gidx], dataset.y_train[gidx]

    def ingest(raw: torch.Tensor, crop: torch.Tensor, flip: torch.Tensor,
               use_kernels: bool) -> torch.Tensor:
        """uint8 rows → augmented, normalized float32 NHWC images: one
        ``augment_normalize`` launch with ``fused_input``, the op chain
        otherwise."""
        if config.fused_input:
            fused = augment_normalize if use_kernels else reference.augment_normalize
            return fused(raw, mean_t, std_t, crop, flip, CROP_PAD)
        images = normalize_images(raw, dataset.mean, dataset.std)
        if config.augmentation == "noniid":
            images = augment_batch(images, crop, flip, CROP_PAD)
        return images

    def step_fn(state: MercuryState, draws: Optional[Draws] = None,
                use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = make_draws(state, config)
        nll = per_sample_nll if use_kernels else reference.nll_forward
        model = state.model
        dev = state.stream.perm.device
        autocast = torch.autocast(device_type=dev.type, dtype=torch.bfloat16,
                                  enabled=bf16 and dev.type == "cuda")

        def score(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
            """Train-mode scoring forward (running statistics left alone)
            and per-sample NLL, without gradients."""
            with torch.no_grad(), autocast:
                logits = model(to_nchw(images), train=True, keep_stats=False)
                return nll(logits, labels)

        stream, ema, table = state.stream, state.ema, state.scoretable
        if use_table:
            r_slots = refresh_window(table, refresh_size)
            r_raw, r_labels = gather(r_slots)
            r_scores = score(ingest(r_raw, draws.crop, draws.flip, use_kernels),
                             r_labels)
            avg_pool_loss = pool_mean(r_scores)
            ema = ema_update(ema, avg_pool_loss, config.ema_alpha)
            refresh_draw = (table_refresh_draw if use_kernels
                            else reference.table_refresh_draw)
            new_scores, probs, selected, scaled_probs = refresh_draw(
                table.scores, r_slots, r_scores, ema.value, draws.uniforms,
                config.is_alpha, config.table_decay)
            selected = selected.long()
            sel_raw, sel_labels = gather(selected)
            sel_images = ingest(sel_raw, draws.crop2, draws.flip2, use_kernels)
        else:
            def need_perm() -> torch.Tensor:
                if draws.perm is None:
                    raise ValueError("the stream wraps this step: draws.perm is required")
                return draws.perm

            stream, slots = next_pool(stream, p_size, need_perm)
            raw, labels = gather(slots)
            images = ingest(raw, draws.crop, draws.flip, use_kernels)  # [P, H, W, C]
            if use_is:
                pool_losses = score(images, labels)
                avg_pool_loss = pool_mean(pool_losses)
                ema = ema_update(ema, avg_pool_loss, config.ema_alpha)
                select = score_and_draw if use_kernels else reference.score_and_draw
                probs, selected, scaled_probs = select(
                    pool_losses, ema.value, draws.uniforms, config.is_alpha)
                selected = selected.long()
                sel_images, sel_labels = images[selected], labels[selected]
            else:
                probs = None
                selected = torch.arange(batch_size, device=dev)
                sel_images, sel_labels = images[:batch_size], labels[:batch_size]
                scaled_probs = torch.ones(batch_size, dtype=torch.float32, device=dev)
                avg_pool_loss = torch.zeros((), dtype=torch.float32, device=dev)

        # --- train update: reweighted forward/backward, optimizer step.
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        with autocast:
            logits = model(to_nchw(sel_images), train=True,
                           keep_stats=True)
        train_losses = nll(logits, sel_labels)
        loss = reweighted_loss(train_losses, scaled_probs)
        loss.backward()
        state.optimizer.step()

        if use_table:
            # Write-back: the trained slots' fresh scores are the loss's own
            # per-sample NLLs of the float32 logits — the numbers the JAX
            # step recomputes from the same logits — duplicates averaged.
            with torch.no_grad():
                scores = scatter_mean(new_scores, selected, train_losses.detach())
            table = ScoreTableState(scores, advance_cursor(table, refresh_size))
        state.step += 1
        state.ema = ema
        state.stream = stream
        state.scoretable = table
        with torch.no_grad():
            acc = (logits.argmax(dim=-1) == sel_labels).float().mean()
        metrics = {
            "train/loss": loss.detach(),
            "train/acc": acc,
            "train/pool_loss": avg_pool_loss,
            # [B] pool positions, or table slots, trained on
            "sampler/selected": selected,
        }
        if probs is not None:
            metrics["sampler/probs"] = probs  # [P] or [L]: what the batch was drawn from
        return metrics

    return step_fn
