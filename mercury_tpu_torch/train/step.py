"""The Mercury step of the port: one rank's share of a data-parallel step.

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
   (``nll_fwd`` forward, ``nll_bwd`` backward) and applies the optimizer;
   at ``grad_accum_steps=A > 1`` it folds the gradient into the
   accumulator instead and applies the update every A-th step
   (:func:`accumulate`). The BN running statistics, the EMA and the stream
   or score table advance every step either way.

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
launch that gathers the uint8 rows itself (its ``rows``): no separate
gather of the images. With ``use_importance_sampling=False`` the step is
the uniform control arm: the streamed batch itself, weight 1.

At ``world_size=W>1`` each rank runs this step on its own shard (row
``dataset.rank`` of the partition) with its own draws, in a process group
of W ranks, and these cross the ranks (``parallel/collectives.py``):

- with ``batch_norm="sync"``, every BN layer's batch statistics, in the
  scoring forward, the train forward and the backward (one all-reduce a
  layer in each);
- with ``sync_importance_stats``, the pool mean feeding the EMA (a sum and
  a count);
- the gradients, as one bucket before the optimizer step;
- the BN running statistics, as one bucket after it (under ``"local"``
  too);
- the metrics: ``train/loss`` and ``train/pool_loss`` as means over the
  ranks, ``train/acc`` as the global correct count over the global count.

At W=1 the step issues no collective and needs no process group.

With ``config.telemetry`` (the default, as in the JAX package) the step
also returns the sampler's health (``obs/``): ``sampler/ess``,
``sampler/clip_frac``, ``sampler/ema_drift``, ``train/grad_norm`` (after the
all-reduce, before the optimizer or the accumulator) and, with importance
sampling, the IS weights' histogram ``sampler_dist/w_hist/b00..b15``; on the
scoretable path also ``sampler/table_age_{min,mean,max}``, the refreshed
table's histogram ``sampler_dist/score_hist/b00..b15``, and it adds each
trained slot to the ledger ``state.sel_counts``. With
``variance_probe_every=K > 0`` every K-th step runs one more no-grad forward
of the drawn batch through the pre-update model for
``sampler_dist/var_ratio`` (−1.0 on the other steps). At W>1 the scalars are
means over the ranks and the histograms sums, carried by the metrics'
all-reduce. With ``telemetry=False`` none of this is computed.

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
from mercury_tpu_torch.obs.diagnostics import (
    clip_fraction,
    ema_drift,
    ess_fraction,
    global_grad_norm,
    table_age_summary,
)
from mercury_tpu_torch.obs.sampler_health import (
    HIST_BINS,
    SCORE_HIST_HI,
    SCORE_HIST_LO,
    WEIGHT_HIST_HI,
    WEIGHT_HIST_LO,
    hist_keys,
    log_bin_histogram,
    variance_probe_ratio,
)
from mercury_tpu_torch.ops import reference
from mercury_tpu_torch.ops.mercury_kernels import (
    augment_normalize,
    per_sample_nll,
    score_and_draw,
    table_refresh_draw,
)
from mercury_tpu_torch.parallel.collectives import allreduce_mean_, allreduce_sum
from mercury_tpu_torch.parallel.distributed import require_world
from mercury_tpu_torch.sampling.importance import (
    ema_update,
    per_sample_grad_norm_bound,
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


def set_lr(state: MercuryState) -> None:
    """The learning rate of the next update, ``lr_schedule(updates)``."""
    lr = state.lr_schedule(state.updates)
    for group in state.optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def accumulate(state: MercuryState, accum_steps: int) -> None:
    """optax.MultiSteps for one microstep: fold the gradients into the
    running mean ``acc + (g − acc) / (mini_step + 1)`` (its ``_acc_update``;
    a sum divided at the end would round otherwise), and on the
    ``accum_steps``-th microstep apply the mean as the gradient at
    ``lr_schedule(updates)`` and zero the accumulator. Between updates the
    parameters and the optimizer state do not change."""
    params = list(state.model.parameters())
    diff = torch._foreach_sub([p.grad for p in params], state.accum)
    torch._foreach_div_(diff, float(state.mini_step + 1))
    torch._foreach_add_(state.accum, diff)
    state.mini_step += 1
    if state.mini_step < accum_steps:
        return
    for p, acc in zip(params, state.accum):
        p.grad = acc
    set_lr(state)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    torch._foreach_zero_(state.accum)
    state.mini_step = 0
    state.updates += 1


def make_train_step(
    config: TrainConfig, dataset: ShardedDataset,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step_fn(state, draws=None, use_kernels=True) → metrics``.

    ``step_fn`` advances ``state`` in place (model, optimizer, EMA, stream
    or score table, step, and the accumulator at ``grad_accum_steps > 1``)
    and returns the step's metrics as device tensors
    — scalars, the ``[B]`` pool positions or table slots drawn and the
    distribution they were drawn from — so a caller that does not read
    them never waits for the device. The three table ages, which the host
    knows from the cursor, are float32 CPU scalars.
    ``use_kernels=False`` swaps the kernels for their plain versions on the
    same device — for holding one against the other, not for training.
    At W>1 the process group must have ``config.world_size`` ranks."""
    require_world(config.world_size)
    world_size = config.world_size
    use_is = config.use_importance_sampling
    use_table = config.use_scoretable
    sync_stats = use_is and config.sync_importance_stats and world_size > 1
    p_size = pool_size(config)
    batch_size = config.batch_size
    refresh_size = config.refresh_size
    bf16 = config.compute_dtype == "bfloat16"
    accum_steps = config.grad_accum_steps
    telemetry = config.telemetry
    if telemetry and use_table:
        # The ages are a rotation of the same L values at every cursor.
        ages = {f"sampler/table_age_{name}": torch.tensor(value, dtype=torch.float32)
                for name, value in zip(("min", "mean", "max"),
                                       table_age_summary(dataset.shard_len, refresh_size))}
    if dataset.x_shard is not None:
        # Sharded placement: the rank's own rows, indexed by slot.
        x_rows, y_rows, shard_row = dataset.x_shard, dataset.y_shard, None
    else:
        x_rows, y_rows = dataset.x_train, dataset.y_train
        shard_row = dataset.shard_indices[dataset.rank]
    mean_t = torch.as_tensor(dataset.mean, dtype=torch.float32, device=x_rows.device)
    std_t = torch.as_tensor(dataset.std, dtype=torch.float32, device=x_rows.device)

    def gather(slots: torch.Tensor):
        """The rows of ``x_rows`` that hold shard ``slots``, and their
        labels."""
        rows = slots if shard_row is None else shard_row[slots]
        return rows, y_rows[rows]

    def ingest(gidx: torch.Tensor, crop: torch.Tensor, flip: torch.Tensor,
               use_kernels: bool) -> torch.Tensor:
        """Rows ``gidx`` of ``x_rows`` → augmented, normalized float32 NHWC
        images: with ``fused_input`` one ``augment_normalize`` launch that
        gathers the uint8 rows itself, the gather and the op chain
        otherwise."""
        if config.fused_input:
            if use_kernels:
                return augment_normalize(x_rows, mean_t, std_t, crop, flip,
                                         CROP_PAD, rows=gidx)
            return reference.augment_normalize(x_rows[gidx], mean_t, std_t,
                                               crop, flip, CROP_PAD)
        images = normalize_images(x_rows[gidx], dataset.mean, dataset.std)
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

        def probe_var_ratio(images: torch.Tensor, labels: torch.Tensor,
                            scaled_probs: torch.Tensor) -> torch.Tensor:
            """The grad-variance probe: the drawn batch through the
            pre-update model (train mode, running statistics left alone,
            no gradients), the gradient-norm bounds of its logits and
            their two moments, pooled over the ranks before the ratio."""
            with torch.no_grad():
                with autocast:
                    logits = model(to_nchw(images), train=True, keep_stats=False)
                g = per_sample_grad_norm_bound(logits.float(), labels)
                return variance_probe_ratio(
                    g, scaled_probs, mean=lambda v: pool_mean(v, sync_stats))

        stream, ema, table = state.stream, state.ema, state.scoretable
        if use_table:
            r_slots = refresh_window(table, refresh_size)
            r_rows, r_labels = gather(r_slots)
            r_scores = score(ingest(r_rows, draws.crop, draws.flip, use_kernels),
                             r_labels)
            avg_pool_loss = pool_mean(r_scores, sync_stats)
            ema_prev = ema.value
            ema = ema_update(ema, avg_pool_loss, config.ema_alpha)
            refresh_draw = (table_refresh_draw if use_kernels
                            else reference.table_refresh_draw)
            new_scores, probs, selected, scaled_probs = refresh_draw(
                table.scores, r_slots, r_scores, ema.value, draws.uniforms,
                config.is_alpha, config.table_decay)
            selected = selected.long()
            if telemetry:
                # Over the whole refreshed table, before the write-back:
                # what the draw normalized.
                clip = clip_fraction(new_scores, ema.value, config.is_alpha)
                drift = ema_drift(avg_pool_loss, ema_prev)
            sel_rows, sel_labels = gather(selected)
            sel_images = ingest(sel_rows, draws.crop2, draws.flip2, use_kernels)
        else:
            def need_perm() -> torch.Tensor:
                if draws.perm is None:
                    raise ValueError("the stream wraps this step: draws.perm is required")
                return draws.perm

            stream, slots = next_pool(stream, p_size, need_perm)
            rows, labels = gather(slots)
            images = ingest(rows, draws.crop, draws.flip, use_kernels)  # [P, H, W, C]
            if use_is:
                pool_losses = score(images, labels)
                avg_pool_loss = pool_mean(pool_losses, sync_stats)
                ema_prev = ema.value
                ema = ema_update(ema, avg_pool_loss, config.ema_alpha)
                select = score_and_draw if use_kernels else reference.score_and_draw
                probs, selected, scaled_probs = select(
                    pool_losses, ema.value, draws.uniforms, config.is_alpha)
                selected = selected.long()
                sel_images, sel_labels = images[selected], labels[selected]
                if telemetry:
                    clip = clip_fraction(pool_losses, ema.value, config.is_alpha)
                    drift = ema_drift(avg_pool_loss, ema_prev)
            else:
                probs = None
                selected = torch.arange(batch_size, device=dev)
                sel_images, sel_labels = images[:batch_size], labels[:batch_size]
                scaled_probs = torch.ones(batch_size, dtype=torch.float32, device=dev)
                avg_pool_loss = torch.zeros((), dtype=torch.float32, device=dev)
                if telemetry:
                    # Nothing scored: nothing clips or drifts.
                    clip = drift = torch.zeros((), dtype=torch.float32, device=dev)

        # The probe's cadence counts the steps after this one, as the JAX
        # step's metric records do.
        probe = config.use_probe and (state.step + 1) % config.variance_probe_every == 0
        if probe:
            var_ratio = probe_var_ratio(sel_images, sel_labels, scaled_probs)

        # --- train update: reweighted forward/backward, optimizer step (at
        # A > 1 the gradient is folded into the accumulator instead, and
        # every A-th microstep applies it).
        if state.accum is None:
            set_lr(state)
        state.optimizer.zero_grad(set_to_none=True)
        with autocast:
            logits = model(to_nchw(sel_images), train=True,
                           keep_stats=True)
        train_losses = nll(logits, sel_labels)
        loss = reweighted_loss(train_losses, scaled_probs)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if world_size > 1:
            allreduce_mean_(grads)
        if telemetry:
            # This (micro)step's gradient, equal on every rank.
            grad_norm = global_grad_norm(grads)
        if state.accum is None:
            state.optimizer.step()
            state.updates += 1
        else:
            accumulate(state, accum_steps)
        if world_size > 1:
            # Averaged under "sync" (already equal) and "local" alike, as
            # the JAX step averages batch_stats.
            allreduce_mean_([b for name, b in model.named_buffers()
                             if name.endswith(("running_mean", "running_var"))])

        if use_table:
            # Write-back: the trained slots' fresh scores are the loss's own
            # per-sample NLLs of the float32 logits — the numbers the JAX
            # step recomputes from the same logits — duplicates averaged.
            with torch.no_grad():
                scores = scatter_mean(new_scores, selected, train_losses.detach())
                if config.use_ledger:
                    if state.sel_counts is None:  # a state built without one
                        state.sel_counts = torch.zeros_like(scores, dtype=torch.int32)
                    # One count an occurrence: a slot drawn twice counts twice.
                    state.sel_counts.index_add_(
                        0, selected, torch.ones_like(selected, dtype=torch.int32))
            table = ScoreTableState(scores, advance_cursor(table, refresh_size))
        state.step += 1
        state.ema = ema
        state.stream = stream
        state.scoretable = table
        means: Dict[str, torch.Tensor] = {}  # telemetry scalars, averaged at W>1
        hists: Dict[str, torch.Tensor] = {}  # telemetry histograms, summed at W>1
        with torch.no_grad():
            if telemetry:
                means = {"sampler/ess": ess_fraction(scaled_probs),
                         "sampler/clip_frac": clip, "sampler/ema_drift": drift}
                if probe:
                    means["sampler_dist/var_ratio"] = var_ratio
                if use_is:
                    hists["w_hist"] = log_bin_histogram(scaled_probs, WEIGHT_HIST_LO,
                                                        WEIGHT_HIST_HI)
                if use_table:
                    # The table after the write-back: what the next draw reads.
                    hists["score_hist"] = log_bin_histogram(table.scores, SCORE_HIST_LO,
                                                            SCORE_HIST_HI)
            hits = logits.argmax(dim=-1) == sel_labels
            loss = loss.detach()
            if world_size == 1:
                acc = hits.float().mean()
            else:
                # One all-reduce: [Σ loss, Σ pool loss, Σ correct, Σ count],
                # then the telemetry's scalars and its histograms' counts in
                # float32 (exact below 2²⁴).
                flat = torch.stack([loss, avg_pool_loss, hits.float().sum(),
                                    loss.new_full((), hits.numel()), *means.values()])
                if hists:
                    flat = torch.cat([flat, *(h.float() for h in hists.values())])
                sums = allreduce_sum(flat)
                loss, avg_pool_loss = sums[0] / world_size, sums[1] / world_size
                acc = sums[2] / sums[3]
                at = 4
                for key in means:
                    means[key] = sums[at] / world_size
                    at += 1
                for key in hists:
                    hists[key] = sums[at:at + HIST_BINS].to(torch.int32)
                    at += HIST_BINS
        metrics = {
            "train/loss": loss,
            "train/acc": acc,
            "train/pool_loss": avg_pool_loss,
            # [B] pool positions, or table slots, trained on
            "sampler/selected": selected,
        }
        if probs is not None:
            metrics["sampler/probs"] = probs  # [P] or [L]: what the batch was drawn from
        if telemetry:
            metrics.update(means)
            metrics["train/grad_norm"] = grad_norm
            if use_table:
                metrics.update(ages)
            for family, counts in hists.items():
                metrics.update(zip(hist_keys(family), counts))
            if config.use_probe and not probe:
                metrics["sampler_dist/var_ratio"] = torch.full(
                    (), -1.0, dtype=torch.float32, device=dev)
        return metrics

    return step_fn
